"""Uniform model API: family dispatch, mirroring `repro/models/api.py`.

Every family module implements:
  init(generator, cfg, dims, device) -> params
  train_loss(params, batch, cfg, dims) -> (loss, metrics)
  prefill(params, batch, cfg, dims) -> (logits [B,V], decode_state)
  init_decode_state(cfg, dims, batch, kv_len, device) -> state
  decode_step(params, state, cfg, dims, *, token/embed, pos) -> (logits, state)

Ported so far: the transformer family (`dense`, `moe`). The `ssm`,
`hybrid` and `encdec` families follow in a later slice (ROADMAP.md,
queue 1, item 9).
"""
from __future__ import annotations

from repro_torch.common.config import ArchConfig
from repro_torch.models import transformer

_FAMILIES = {
    "dense": transformer,
    "moe": transformer,
}

_NOT_YET = ("ssm", "hybrid", "encdec")


def get_model(cfg: ArchConfig):
    if cfg.family in _NOT_YET:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported to "
            f"repro_torch yet: ROADMAP.md, queue 1, item 9")
    return _FAMILIES[cfg.family]
