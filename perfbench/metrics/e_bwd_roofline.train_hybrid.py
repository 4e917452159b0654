"""Kernel E's backward kernels' (`flash_bwd_di_f32_kernel`,
`flash_bwd_dkdv_f32_kernel` and `flash_bwd_dq_f32_kernel`,
kernels/csrc/flash_attention_bwd.cu) share of their roofline in the
hybrid training step, percent: each backward call (one dq launch) is a
shared block's causal attention over [num_attention_heads x micro_batch,
seq_len, attention_head_dim], counted as 7 products of the unmasked
pairs (P and dP in each of two kernels, then dV, dK and dQ: 7/2 of
`counts/model_flops.flash_flops`) at three TF32 products a product (the
kernels' 3xTF32), over the three kernels' device time."""
from perfbench.counts.model_flops import flash_flops
from perfbench.counts.peaks import TF32_TC_FLOPS


def read(data):
    ks = [(n, b - a) for n, a, b in data["kernels"] if "flash_bwd_" in n]
    calls = sum(1 for n, _ in ks if "flash_bwd_dq_f32_kernel" in n)
    c = data["counters"]
    if not calls or not c.get("seq"):
        return None
    m = data["config"]["model"]
    bh = m["num_attention_heads"] * data["workload"]["traffic"]["micro_batch"]
    one = 7 * flash_flops(bh, c["seq"], m["attention_head_dim"]) // 2
    return 100.0 * (calls * 3 * one / TF32_TC_FLOPS) / sum(t for _, t in ks)
