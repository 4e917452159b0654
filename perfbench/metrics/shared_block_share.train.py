"""Share of the traced window the card spends in the hybrid's shared
blocks (`models/hybrid._shared_block`: each application's attention,
MLP with its adapter, and `linear`; the step's forward and each
rematerialized forward, not their backward), percent: the device seconds
of the program's `hybrid.shared` spans (CUDA events at their entry and
exit, read after the window's last synchronisation) over the window. A
program without the span reads None."""


def read(data):
    try:
        from repro_torch.common import trace
    except ImportError:         # a program without the recorder
        return None
    t0, t1 = data["window"]
    spans = [s for s in trace.records((t0, t1)) if s.name == "hybrid.shared"]
    if not spans or t1 <= t0:
        return None
    return 100.0 * sum(trace.device_seconds(s) for s in spans) / (t1 - t0)
