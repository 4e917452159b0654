"""Kernel E's (`flash_attention_f32_kernel`, kernels/csrc/flash_attention.cu,
the forward of `flash_attention_trainable`) share of its roofline in the
training step, percent: every launch the trace holds is a causal forward
over the cell's [heads, seq_len, head_dim] (the step's forward and each
layer's rematerialized forward), counted as the S(S+1)/2 unmasked pairs
(`counts/model_flops.flash_flops`) at three TF32 products a product
(E's 3xTF32, quicker than the CUDA cores' float32 rate), over E's
device time."""
from perfbench.counts.model_flops import flash_flops
from perfbench.counts.peaks import TF32_TC_FLOPS


def read(data):
    ks = [b - a for n, a, b in data["kernels"]
          if "flash_attention_f32_kernel" in n]
    c = data["counters"]
    if not ks or not c.get("seq"):
        return None
    m = data["config"]["model"]
    bh = m["num_attention_heads"] * data["workload"]["traffic"]["micro_batch"]
    one = flash_flops(bh, c["seq"], m["head_dim"])
    return 100.0 * (len(ks) * 3 * one / TF32_TC_FLOPS) / sum(ks)
