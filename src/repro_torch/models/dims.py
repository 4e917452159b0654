"""Resolved model dimensions: config + mesh-dependent padding decisions,
mirroring `repro/models/dims.py` with torch dtypes."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.common.config import ArchConfig


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class Dims:
    cfg: ArchConfig
    tp: int                      # tensor-parallel ways the heads are padded for
    n_q: int                     # padded q heads (multiple of tp)
    n_kv: int                    # kv heads (never padded; replicated if !kv_sharded)
    kv_sharded: bool
    vocab: int                   # padded vocab
    ssm_heads: int               # padded SSD heads
    d_inner: int                 # padded ssm inner dim (ssm_heads * head_dim)
    compute_dtype: torch.dtype
    param_dtype: torch.dtype

    @property
    def head_dim(self) -> int:
        return self.cfg.attention.head_dim

    @property
    def q_group(self) -> int:
        return self.n_q // self.n_kv


def make_dims(cfg: ArchConfig, tp: int = 1,
              compute_dtype=torch.bfloat16,
              param_dtype=torch.bfloat16) -> Dims:
    att = cfg.attention
    if att is not None:
        # q heads padded to a multiple of lcm(tp, n_kv): TP divides evenly AND
        # the GQA head->group map stays uniform. Zero-padded heads are inert
        # (uniform softmax output hits zero rows of W_o).
        lcm = tp * att.n_kv_heads // _gcd(tp, att.n_kv_heads)
        n_q = _round_up(att.n_heads, lcm)
        kv_sharded = att.n_kv_heads % tp == 0
        n_kv = att.n_kv_heads
    else:
        n_q, n_kv, kv_sharded = 0, 0, False
    if cfg.ssm is not None:
        nh = cfg.ssm.n_heads(cfg.d_model)
        ssm_heads = nh if nh % tp == 0 else _round_up(nh, tp)
        d_inner = ssm_heads * cfg.ssm.head_dim
    else:
        ssm_heads, d_inner = 0, 0
    return Dims(
        cfg=cfg, tp=tp, n_q=n_q, n_kv=n_kv, kv_sharded=kv_sharded,
        vocab=cfg.padded_vocab, ssm_heads=ssm_heads, d_inner=d_inner,
        compute_dtype=compute_dtype, param_dtype=param_dtype,
    )


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a
