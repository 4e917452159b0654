"""Mamba2 (SSD) family: attention-free LM, mirroring
`repro/models/mamba.py`. Covers mamba2-130m.

No KV cache: the decode state is each layer's (ssd state, conv tails).
The reference's `lax.scan` over the stacked layers is a Python loop over
the layer axis here, and its per-layer `jax.checkpoint` in train mode is
`transformer.remat`. On CUDA tensors every layer's chunked SSD in
`forward` and `prefill` is kernel F (`layers.ssd_chunked`),
differentiable: in train mode F runs twice a layer and step, the forward
and the backward's recompute. Decode is plain torch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import loss as LS
from repro_torch.models.dims import Dims
from repro_torch.common.treeutil import tree_unbind
from repro_torch.models.transformer import (_embed_in, _stack, layer_params,
                                            remat)
from repro_torch.parallel.sharding import shd


def init(gen: torch.Generator, cfg, dims: Dims, device="cuda"):
    """Random params drawn from `gen`, which lives on `device` (the card
    unless the caller asks for the CPU)."""
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "embed": B._norm(gen, (dims.vocab, cfg.d_model), dims.param_dtype,
                         device),
        "layers": _stack([B.init_mamba(gen, dims, device, out_scale)
                          for _ in range(cfg.n_layers)]),
        "final_ln": torch.ones((cfg.d_model,), dtype=dims.param_dtype,
                               device=device),
    }


def param_specs(cfg, dims: Dims) -> dict:
    return {"embed": ("vocab", "fsdp"),
            "layers": B.stack_specs(B.mamba_specs()), "final_ln": (None,)}


def forward(params, cfg, dims: Dims, *, tokens=None, embeds=None,
            positions=None, mode: str = "train"):
    """Full-sequence forward. Returns (h_final, states_or_None): in
    prefill mode each layer's decode state, stacked over the layers."""
    h = _embed_in(params, dims, tokens, embeds)
    h = shd(h, "batch", "seq", None)
    collect = mode == "prefill"
    states = []

    def body(h, lp):
        return B.apply_mamba(lp, h, dims, return_state=collect)

    for lp in tree_unbind(params["layers"], cfg.n_layers):
        h, st = remat(body, mode, h, lp)
        if collect:
            states.append(st)
    h = L.rmsnorm(h, params["final_ln"], cfg.norm_eps)
    return h, _stack(states) if collect else None


def train_loss(params, batch, cfg, dims: Dims):
    """(loss, metrics): differentiable in the params."""
    h, _ = forward(params, cfg, dims, tokens=batch.get("tokens"),
                   embeds=batch.get("embeds"), mode="train")
    return LS.lm_loss(h, params["embed"].T, batch["labels"],
                      logical_vocab=cfg.vocab_size)


def prefill(params, batch, cfg, dims: Dims):
    """Returns (last-token logits [B,V], decode state: {"ssd", "conv_x",
    "conv_B", "conv_C"}, each stacked over the layers)."""
    h, states = forward(params, cfg, dims, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"), mode="prefill")
    logits = LS.logits_for(L.last_position(h), params["embed"].T, cfg.vocab_size)
    return logits, states


def init_decode_state(cfg, dims: Dims, batch: int, kv_len: int,
                      device="cuda"):
    one = B.mamba_state_shapes(dims, batch, device)
    return {k: torch.zeros((cfg.n_layers,) + tuple(z.shape), dtype=z.dtype,
                           device=device) for k, z in one.items()}


def decode_state_specs(cfg, dims: Dims) -> dict:
    return B.mamba_decode_state_specs()


def decode_step(params, state, cfg, dims: Dims, *, token=None, embed=None,
                pos=None):
    """One-token decode. token [B] / embed [B,D]. Returns (logits [B,V],
    new state)."""
    if embed is not None:
        h = embed[:, None, :].to(dims.compute_dtype)
    else:
        h = L.embed_lookup(params["embed"],
                           token[:, None]).to(dims.compute_dtype)
    states = []
    for li in range(cfg.n_layers):
        h, st = B.apply_mamba_decode(layer_params(params, li), h, dims,
                                     {k: v[li] for k, v in state.items()})
        states.append(st)
    h = L.rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = LS.logits_for(h[:, 0], params["embed"].T, cfg.vocab_size)
    return logits, _stack(states)
