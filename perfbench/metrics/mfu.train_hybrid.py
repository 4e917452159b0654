"""The whole hybrid training step's share of the card's float32 peak
(outside the tensor cores; the model trains in float32 with TF32 off),
percent: the step's model FLOPs (`counts/hybrid_flops.train_step_flops`:
three times the forward of the configuration's layers, each shared-block
application counted, the SSD at the program's chunk, no credit for
rematerialization) times the steps the window ran, over the traced
window at the peak."""
from perfbench.counts.hybrid_flops import train_step_flops
from perfbench.counts.peaks import FP32_FLOPS
from perfbench.metrics import window_seconds


def read(data):
    c = data["counters"]
    if not c.get("steps"):
        return None
    fl = c["steps"] * train_step_flops(data["config"]["model"], c["rows"],
                                       c["seq"],
                                       data["config"]["program_chunk"])
    return 100.0 * fl / (window_seconds(data) * FP32_FLOPS)
