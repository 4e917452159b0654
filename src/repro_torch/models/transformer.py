"""Decoder-only transformer family: dense / MoE / VLM-backbone, mirroring
`repro/models/transformer.py`. Covers qwen2-vl-72b, llama4-maverick,
qwen3-moe, internlm2, qwen2.5-14b/3b and qwen2-0.5b.

The reference's `lax.scan` over the stacked layer params is a Python loop
over the layer axis here (`tree_unbind`: one `torch.unbind` a stacked
leaf, whose backward stacks the layers' gradients once, where an index a
layer would build a zero gradient of the whole stack for each), and its
per-layer `jax.checkpoint` in train mode is `remat`
(`torch.utils.checkpoint`, nothing saved inside a layer). On CUDA tensors
the causal attention of `forward` and `prefill` is kernel E
(`layers.chunked_attention`), differentiable, so in train mode E runs
twice a layer and step: the forward and the backward's recompute. Decode
is plain torch.
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.common.treeutil import tree_index, tree_unbind
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import loss as LS
from repro_torch.models.dims import Dims
from repro_torch.parallel.sharding import (current_context, place,
                                           sharding_context, shd)


def _rope_inputs(cfg, dims, positions, bsz, seq, device):
    att = cfg.attention
    if positions is None:
        pos = torch.arange(seq, device=device)[None, :].expand(bsz, seq)
        if att.mrope:
            pos = pos[None].expand(3, bsz, seq)
        positions = pos
    return L.rope_angles(positions, att.head_dim, att.rope_theta,
                         att.mrope_sections if att.mrope else None)


def _stack(trees: list):
    """A list of identically-shaped param trees -> one tree whose leaves
    carry a leading axis over the list (the reference's vmap'd init)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def layer_params(params, li: int) -> dict:
    """Layer `li`'s slice of the stacked ``params["layers"]``."""
    return tree_index(params["layers"], li)


def remat(fn, mode: str, *args):
    """`fn(*args)`; in train mode under autograd, rematerialized in
    backward (`torch.utils.checkpoint`, non-reentrant): the reference's
    `jax.checkpoint(..., nothing_saveable)`. Memory only, values
    unchanged. The layers draw no random numbers, so no RNG state is
    kept. The recompute runs under the forward's sharding context: on
    the card autograd runs it in a thread of its own, which does not see
    the thread-local context."""
    if mode == "train" and torch.is_grad_enabled():
        installed = current_context()

        def run(*a):
            with sharding_context(*installed):
                return fn(*a)

        return torch.utils.checkpoint.checkpoint(
            run, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def init(gen: torch.Generator, cfg, dims: Dims, device="cuda"):
    """Random params drawn from `gen`, which lives on `device` (the card
    unless the caller asks for the CPU)."""
    nl = cfg.n_layers
    out_scale = 0.02 / math.sqrt(2 * nl)

    def one_layer():
        p = {"attn": B.init_attn(gen, dims, device, out_scale=out_scale)}
        if cfg.is_moe:
            p["moe"] = B.init_moe(gen, dims, device, out_scale)
        else:
            p["mlp"] = B.init_mlp(gen, cfg.d_model, cfg.d_ff, dims, device,
                                  out_scale)
        return p

    params = {
        "embed": B._norm(gen, (dims.vocab, cfg.d_model), dims.param_dtype,
                         device),
        "layers": _stack([one_layer() for _ in range(nl)]),
        "final_ln": torch.ones((cfg.d_model,), dtype=dims.param_dtype,
                               device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = B._norm(gen, (cfg.d_model, dims.vocab),
                                    dims.param_dtype, device)
    return params


def param_specs(cfg, dims: Dims) -> dict:
    lp = {"attn": B.attn_specs(dims)}
    if cfg.is_moe:
        lp["moe"] = B.moe_specs(dims)
    else:
        lp["mlp"] = B.mlp_specs()
    specs = {"embed": ("vocab", "fsdp"), "layers": B.stack_specs(lp),
             "final_ln": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "vocab")
    return specs


def _head_matrix(params, dims):
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].T


def _embed_in(params, dims, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(dims.compute_dtype)
    return L.embed_lookup(params["embed"], tokens).to(dims.compute_dtype)


def forward(params, cfg, dims: Dims, *, tokens=None, embeds=None,
            positions=None, mode: str = "train"):
    """Full-sequence forward. Returns (h_final, aux_loss, caches_or_None)."""
    h = _embed_in(params, dims, tokens, embeds)
    bsz, seq = h.shape[:2]
    h = shd(h, "batch", "seq", None)
    sin, cos = _rope_inputs(cfg, dims, positions, bsz, seq, h.device)
    collect_kv = mode == "prefill"
    aux = torch.zeros((), device=h.device)
    ks, vs = [], []

    def body(h, lp):
        h, kv = B.apply_attn(lp["attn"], h, dims, sin=sin, cos=cos,
                             causal=True, mode=mode)
        if cfg.is_moe:
            h, a, _dropped = B.apply_moe(lp["moe"], h, dims)
            return h, a, kv
        return B.apply_mlp(lp["mlp"], h, dims), None, kv

    for lp in tree_unbind(params["layers"], cfg.n_layers):
        h, a, kv = remat(body, mode, h, lp)
        if a is not None:
            aux = aux + a
        if collect_kv:
            ks.append(kv[0].to(dims.compute_dtype))
            vs.append(kv[1].to(dims.compute_dtype))
    h = L.rmsnorm(h, params["final_ln"], cfg.norm_eps)
    caches = ({"k": torch.stack(ks), "v": torch.stack(vs)} if collect_kv
              else None)
    return h, aux, caches


def train_loss(params, batch, cfg, dims: Dims):
    """(loss + MoE aux loss, metrics): differentiable in the params."""
    h, aux, _ = forward(params, cfg, dims,
                        tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                        positions=batch.get("positions"), mode="train")
    loss, metrics = LS.lm_loss(h, _head_matrix(params, dims), batch["labels"],
                               logical_vocab=cfg.vocab_size)
    metrics["aux"] = aux
    return loss + aux, metrics


def prefill(params, batch, cfg, dims: Dims):
    """Returns (last-token logits [B,V], decode state {"k", "v"} of
    [L,B,S,Hkv,dh])."""
    h, _, caches = forward(params, cfg, dims,
                           tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                           positions=batch.get("positions"), mode="prefill")
    logits = LS.logits_for(L.last_position(h), _head_matrix(params, dims),
                           cfg.vocab_size)
    caches = {k: shd(c, None, "batch", "pages", None, None)
              for k, c in caches.items()}
    return logits, caches


def init_decode_state(cfg, dims: Dims, batch: int, kv_len: int,
                      device="cuda"):
    att = cfg.attention
    shape = (cfg.n_layers, batch, kv_len, dims.n_kv, att.head_dim)
    def z():
        return place(torch.zeros(shape, dtype=dims.compute_dtype,
                                 device=device),
                     None, "batch", "pages", None, None)

    return {"k": z(), "v": z()}


def decode_state_specs(cfg, dims: Dims) -> dict:
    kv = (None, "batch", "pages", None, None)
    return {"k": kv, "v": kv}


def decode_step(params, state, cfg, dims: Dims, *, token=None, embed=None,
                pos=None):
    """One-token decode. token [B] / embed [B,D]; pos: int, the current
    length. Returns (logits [B,V], new state)."""
    if embed is not None:
        h = embed[:, None, :].to(dims.compute_dtype)
    else:
        h = L.embed_lookup(params["embed"],
                           token[:, None]).to(dims.compute_dtype)
    bsz = h.shape[0]
    att = cfg.attention
    posv = torch.full((bsz, 1), int(pos), dtype=torch.int32, device=h.device)
    if att.mrope:
        posv = posv[None].expand(3, bsz, 1)
    sin, cos = L.rope_angles(posv, att.head_dim, att.rope_theta,
                             att.mrope_sections if att.mrope else None)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h, (kc, vc) = B.apply_attn(lp["attn"], h, dims, sin=sin, cos=cos,
                                   causal=True, mode="decode",
                                   cache=(state["k"][li], state["v"][li]),
                                   pos=int(pos))
        if cfg.is_moe:
            h, _, _ = B.apply_moe(lp["moe"], h, dims, seq_shard=False)
        else:
            h = B.apply_mlp(lp["mlp"], h, dims, seq_shard=False)
        ks.append(kc)
        vs.append(vc)
    h = L.rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = LS.logits_for(h[:, 0], _head_matrix(params, dims), cfg.vocab_size)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
