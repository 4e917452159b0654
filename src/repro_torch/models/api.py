"""Uniform model API: family dispatch, mirroring `repro/models/api.py`.

Every family module implements:
  init(generator, cfg, dims, device) -> params
  train_loss(params, batch, cfg, dims) -> (loss, metrics)
  prefill(params, batch, cfg, dims) -> (logits [B,V], decode_state)
  init_decode_state(cfg, dims, batch, kv_len, device) -> state
  decode_step(params, state, cfg, dims, *, token/embed, pos) -> (logits, state)

All five families are ported: `dense` and `moe` (transformer), `ssm`
(mamba), `hybrid` and `encdec`.
"""
from __future__ import annotations

from repro_torch.common.config import ArchConfig
from repro_torch.models import encdec, hybrid, mamba, transformer

_FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "ssm": mamba,
    "hybrid": hybrid,
    "encdec": encdec,
}


def get_model(cfg: ArchConfig):
    return _FAMILIES[cfg.family]
