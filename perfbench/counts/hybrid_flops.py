"""Operations of the hybrid (Zamba2) model cells, from shapes alone.

As `model_flops`: a matrix product of an [m, k] and a [k, n] operand is
2*m*k*n operations; norms, biases, the conv, rotations, activations and
the softmax's exponentials are left out, so every count is a floor. A
shared block is counted at each of its applications, as it runs.
"""
from __future__ import annotations

from perfbench.counts.model_flops import flash_flops
from perfbench.reference.zamba2 import widths


def ssd_operations(b: int, s: int, h: int, p: int, n: int, chunk: int,
                   groups: int) -> int:
    """Kernel F's operations over x [b, s, h, p] and B/C [b, s, groups,
    n] in chunks of `chunk` (a frozen copy of
    `repro_torch.kernels.mamba2_ssd.operations`): per (batch, chunk,
    group) C·Bᵀ over the L(L+1)/2 pairs j <= i, then per head the
    weighted dt·x over the same pairs, C·hᵀ and the chunk's state."""
    l = min(chunk, s)
    pairs = l * (l + 1) // 2
    return 2 * b * (s // l) * (groups * pairs * n
                               + h * (pairs * p + 2 * l * p * n))


def forward_flops(cfg: dict, seq_len: int, chunk: int) -> int:
    """One causal sequence's forward: every layer's Mamba mixer (its two
    projections and the SSD in chunks of `chunk`), every shared-block
    application (q, k, v over the concatenated input, the output
    projection, q·k and p·v over the unmasked pairs, the MLP with its
    adapter, the layer's `linear`) and the tied head."""
    w = widths(cfg)
    d, f, r = w["d"], cfg["intermediate_size"], cfg["adapter_rank"]
    apps = len(cfg["hybrid_layer_ids"])
    hd = w["nq"] * w["dh"]
    mamba = 2 * d * (w["di"] + w["conv"] + w["h"]) + 2 * w["di"] * d
    shared = (2 * 2 * d * 3 * hd + 2 * hd * d + 2 * d * 2 * f + 2 * f * d
              + 2 * r * (d + 2 * f) + 2 * d * d)
    per_token = (cfg["num_hidden_layers"] * mamba + apps * shared
                 + 2 * d * cfg["vocab_size"])
    ssd = ssd_operations(1, seq_len, w["h"], w["p"], w["n"], chunk, w["g"])
    return (seq_len * per_token + apps * flash_flops(w["nq"], seq_len,
                                                     w["dh"])
            + cfg["num_hidden_layers"] * ssd)


def train_step_flops(cfg: dict, seqs: int, seq_len: int, chunk: int) -> int:
    """A training step over `seqs` sequences: forward and backward, three
    times the forward, no credit for the rematerialized forward."""
    return 3 * seqs * forward_flops(cfg, seq_len, chunk)
