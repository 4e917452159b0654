"""Zamba2-style hybrid, mirroring `repro/models/hybrid.py`: a Mamba2
backbone plus ONE shared-weight attention(+MLP) block applied every
`attn_every` layers.

81 blocks = 13 groups of [5 mamba + shared attn] + 3 trailing mamba. The
group params are stacked [G, per, ...], the tail's [tail, ...]; the
reference's scans over them are Python loops here, and its
`jax.checkpoint`s in train mode are `transformer.remat` at the same
places: a group, each Mamba layer inside it, each tail layer. On CUDA
tensors each Mamba layer's chunked SSD is kernel F and each application
of the shared attention kernel E (causal, head dim 112 at full width),
both differentiable; decode is plain torch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.treeutil import tree_index, tree_unbind
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import loss as LS
from repro_torch.models.dims import Dims
from repro_torch.models.transformer import _embed_in, _stack, remat


def _split(cfg):
    groups = cfg.n_layers // cfg.attn_every
    per = cfg.attn_every - 1
    tail = cfg.n_layers - groups * cfg.attn_every
    return groups, per, tail


def init(gen: torch.Generator, cfg, dims: Dims, device="cuda"):
    """Random params drawn from `gen`, which lives on `device` (the card
    unless the caller asks for the CPU)."""
    groups, per, tail = _split(cfg)
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)

    def mambas(n):
        return _stack([B.init_mamba(gen, dims, device, out_scale)
                       for _ in range(n)])

    p = {
        "embed": B._norm(gen, (dims.vocab, cfg.d_model), dims.param_dtype,
                         device),
        "groups": _stack([mambas(per) for _ in range(groups)]),
        "shared": {
            "attn": B.init_attn(gen, dims, device, out_scale=out_scale),
            "mlp": B.init_mlp(gen, cfg.d_model, cfg.d_ff, dims, device,
                              out_scale),
        },
        "final_ln": torch.ones((cfg.d_model,), dtype=dims.param_dtype,
                               device=device),
        "lm_head": B._norm(gen, (cfg.d_model, dims.vocab), dims.param_dtype,
                           device),
    }
    if tail:
        p["tail"] = mambas(tail)
    return p


def _rope(cfg, bsz, seq, device):
    att = cfg.attention
    pos = torch.arange(seq, device=device)[None, :].expand(bsz, seq)
    return L.rope_angles(pos, att.head_dim, att.rope_theta)


def forward(params, cfg, dims: Dims, *, tokens=None, embeds=None,
            positions=None, mode: str = "train"):
    """Full-sequence forward. Returns (h_final, states_or_None): in
    prefill mode {"groups_mamba" [G, per, ...], "k"/"v" [G,B,S,Hkv,dh],
    "tail_mamba" [tail, ...] or None}."""
    groups, per, tail = _split(cfg)
    h = _embed_in(params, dims, tokens, embeds)
    bsz, seq = h.shape[:2]
    sin, cos = _rope(cfg, bsz, seq, h.device)
    collect = mode == "prefill"
    gm, ks, vs, tm = [], [], [], []

    def mamba_body(h, lp):
        return B.apply_mamba(lp, h, dims, return_state=collect)

    def group_body(h, layers, shared):
        sts = []
        for lp in layers:
            # per-layer remat inside the group, as the reference's
            h, st = remat(mamba_body, mode, h, lp)
            sts.append(st)
        h, kv = B.apply_attn(shared["attn"], h, dims, sin=sin, cos=cos,
                             causal=True, mode=mode)
        return B.apply_mlp(shared["mlp"], h, dims), sts, kv

    for gp in tree_unbind(params["groups"], groups):
        h, sts, kv = remat(group_body, mode, h, tree_unbind(gp, per),
                           params["shared"])
        if collect:
            gm.append(_stack(sts))
            ks.append(kv[0].to(dims.compute_dtype))
            vs.append(kv[1].to(dims.compute_dtype))
    for lp in (tree_unbind(params["tail"], tail) if tail else ()):
        h, st = remat(mamba_body, mode, h, lp)
        tm.append(st)
    h = L.rmsnorm(h, params["final_ln"], cfg.norm_eps)
    if not collect:
        return h, None
    return h, {"groups_mamba": _stack(gm), "k": torch.stack(ks),
               "v": torch.stack(vs),
               "tail_mamba": _stack(tm) if tail else None}


def train_loss(params, batch, cfg, dims: Dims):
    """(loss, metrics): differentiable in the params."""
    h, _ = forward(params, cfg, dims, tokens=batch.get("tokens"),
                   embeds=batch.get("embeds"), mode="train")
    return LS.lm_loss(h, params["lm_head"], batch["labels"],
                      logical_vocab=cfg.vocab_size)


def prefill(params, batch, cfg, dims: Dims):
    """Returns (last-token logits [B,V], decode state as `forward`'s)."""
    h, states = forward(params, cfg, dims, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"), mode="prefill")
    logits = LS.logits_for(h[:, -1], params["lm_head"], cfg.vocab_size)
    return logits, states


def init_decode_state(cfg, dims: Dims, batch: int, kv_len: int,
                      device="cuda"):
    groups, per, tail = _split(cfg)
    one = B.mamba_state_shapes(dims, batch, device)
    att = cfg.attention

    def stacked(*lead):
        return {k: torch.zeros(lead + tuple(z.shape), dtype=z.dtype,
                               device=device) for k, z in one.items()}

    shape = (groups, batch, kv_len, dims.n_kv, att.head_dim)
    return {"groups_mamba": stacked(groups, per),
            "k": torch.zeros(shape, dtype=dims.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=dims.compute_dtype, device=device),
            "tail_mamba": stacked(tail) if tail else None}


def decode_step(params, state, cfg, dims: Dims, *, token=None, embed=None,
                pos=None):
    """One-token decode. token [B] / embed [B,D]; pos: int, the current
    length. Returns (logits [B,V], new state)."""
    groups, per, tail = _split(cfg)
    if embed is not None:
        h = embed[:, None, :].to(dims.compute_dtype)
    else:
        h = params["embed"][token.long()[:, None]].to(dims.compute_dtype)
    bsz = h.shape[0]
    att = cfg.attention
    posv = torch.full((bsz, 1), int(pos), dtype=torch.int32, device=h.device)
    sin, cos = L.rope_angles(posv, att.head_dim, att.rope_theta)
    gm, ks, vs, tm = [], [], [], []
    for g in range(groups):
        sts = []
        for i in range(per):
            h, st = B.apply_mamba_decode(
                tree_index(params["groups"], (g, i)), h, dims,
                tree_index(state["groups_mamba"], (g, i)))
            sts.append(st)
        h, (kc, vc) = B.apply_attn(params["shared"]["attn"], h, dims,
                                   sin=sin, cos=cos, causal=True,
                                   mode="decode",
                                   cache=(state["k"][g], state["v"][g]),
                                   pos=int(pos))
        h = B.apply_mlp(params["shared"]["mlp"], h, dims)
        gm.append(_stack(sts))
        ks.append(kc)
        vs.append(vc)
    for i in range(tail):
        h, st = B.apply_mamba_decode(tree_index(params["tail"], i), h,
                                     dims, tree_index(state["tail_mamba"], i))
        tm.append(st)
    h = L.rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = LS.logits_for(h[:, 0], params["lm_head"], cfg.vocab_size)
    return logits, {"groups_mamba": _stack(gm), "k": torch.stack(ks),
                    "v": torch.stack(vs),
                    "tail_mamba": _stack(tm) if tail else None}
