"""Share of the traced window the card spends in AdamW
(`optim.apply_updates`, called by `train/step.make_train_step`), percent:
the device seconds of the program's `train.optimizer` spans (CUDA events
at their entry and exit, read after the window's last synchronisation)
over the window."""


def read(data):
    try:
        from repro_torch.common import trace
    except ImportError:         # a program without the recorder
        return None
    t0, t1 = data["window"]
    spans = [s for s in trace.records((t0, t1))
             if s.name == "train.optimizer"]
    if not spans or t1 <= t0:
        return None
    return 100.0 * sum(trace.device_seconds(s) for s in spans) / (t1 - t0)
