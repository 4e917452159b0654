"""Kernel F's (`mamba2_ssd_kernel`, kernels/csrc/mamba2_ssd.cu) share of
its roofline in the training step, percent: every launch the trace holds
is one Mamba layer's SSD forward (the step's forward and each layer's
rematerialized forward) over [micro_batch, seq_len, n_mamba_heads,
mamba_headdim] with B/C in `mamba_ngroups` groups and the program's
chunk, counted as `counts/hybrid_flops.ssd_operations` (C·Bᵀ once a
group) at three TF32 products a product (F's 3xTF32), over F's device
time."""
from perfbench.counts.hybrid_flops import ssd_operations
from perfbench.counts.peaks import TF32_TC_FLOPS


def read(data):
    ks = [b - a for n, a, b in data["kernels"] if "mamba2_ssd_kernel" in n]
    c = data["counters"]
    if not ks or not c.get("seq"):
        return None
    m = data["config"]["model"]
    one = ssd_operations(data["workload"]["traffic"]["micro_batch"],
                         c["seq"], m["n_mamba_heads"], m["mamba_headdim"],
                         m["mamba_d_state"], data["config"]["program_chunk"],
                         m["mamba_ngroups"])
    return 100.0 * (len(ks) * 3 * one / TF32_TC_FLOPS) / sum(ks)
