"""Share of the traced window the card spends in the backward of the
training step's SSD (`ops._SsdTrainable.backward`: autograd of the plain
chunked SSD, recomputed from the saved inputs), percent: the device
seconds of the program's `ssd.backward` spans (CUDA events at their entry
and exit, read after the window's last synchronisation) over the window.
They run inside the `train.backward` spans. Read only where the spans
number as many as the backward calls the program counted in the window
(`mamba2_ssd.BWD_CALLS`, the runner's ``program`` counters): every call
timed. A program without the span or the counter reads None."""


def read(data):
    try:
        from repro_torch.common import trace
    except ImportError:         # a program without the recorder
        return None
    t0, t1 = data["window"]
    spans = [s for s in trace.records((t0, t1)) if s.name == "ssd.backward"]
    calls = data["counters"].get("program", {}).get("ssd_bwd_calls")
    if not spans or t1 <= t0 or calls != len(spans):
        return None
    return 100.0 * sum(trace.device_seconds(s) for s in spans) / (t1 - t0)
