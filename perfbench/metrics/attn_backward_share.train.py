"""Share of the traced window the card spends in the backward of the
training step's attention (`ops._FlashTrainable.backward`: on float32,
the Di, dK/dV and dQ kernels of `kernels/csrc/flash_attention_bwd.cu`),
percent: the device seconds of the program's `attn.backward` spans (CUDA
events at their entry and exit, read after the window's last
synchronisation) over the window. They run inside the `train.backward`
spans, so this is a part of `backward_share.train`. A program without
the span reads None."""


def read(data):
    try:
        from repro_torch.common import trace
    except ImportError:         # a program without the recorder
        return None
    t0, t1 = data["window"]
    spans = [s for s in trace.records((t0, t1)) if s.name == "attn.backward"]
    if not spans or t1 <= t0:
        return None
    return 100.0 * sum(trace.device_seconds(s) for s in spans) / (t1 - t0)
