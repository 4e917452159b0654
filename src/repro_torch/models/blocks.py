"""Parameter init + apply for the reusable blocks (attention, MLP, MoE),
mirroring `repro/models/blocks.py`. Model families compose these over a
stacked layer axis.

Conventions:
  * params are plain nested dicts of tensors, stacked along a leading
    layer axis by the family code;
  * init draws every random number from the `torch.Generator` it is
    given, on the generator's device (`device`);
  * padded q heads are zero-initialized and masked at init so the padded
    model is numerically identical to the logical one;
  * `mode` is one of 'train' | 'prefill' | 'decode'.

The reference's sharding annotations and its `shard_map` MoE branch have
no counterpart on one card: `apply_moe` is the reference's no-mesh path.
The mamba and cross-attention blocks come with their families.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.dims import Dims


def _norm(gen: torch.Generator, shape, dtype, device, scale=0.02):
    """Normal(0, scale) drawn in float32, then cast to `dtype`."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


# ============================================================== attention

def init_attn(gen: torch.Generator, dims: Dims, device, *,
              out_scale: float) -> dict:
    cfg = dims.cfg
    att = cfg.attention
    d, dh = cfg.d_model, att.head_dim
    nq, nkv = dims.n_q, dims.n_kv
    pdt = dims.param_dtype
    qmask = (torch.arange(nq, device=device) < att.n_heads).to(pdt)
    p = {
        "ln": torch.ones((d,), dtype=pdt, device=device),
        "wq": _norm(gen, (d, nq, dh), pdt, device) * qmask[None, :, None],
        "wk": _norm(gen, (d, nkv, dh), pdt, device),
        "wv": _norm(gen, (d, nkv, dh), pdt, device),
        "wo": (_norm(gen, (nq, dh, d), pdt, device, out_scale)
               * qmask[:, None, None]),
    }
    if att.qkv_bias:
        p["bq"] = torch.zeros((nq, dh), dtype=pdt, device=device)
        p["bk"] = torch.zeros((nkv, dh), dtype=pdt, device=device)
        p["bv"] = torch.zeros((nkv, dh), dtype=pdt, device=device)
    return p


def _project_qkv(p, x, dims: Dims, sin, cos, rope: bool):
    dt = x.dtype
    q = L.eins("bsd,dhk->bshk", x, p["wq"])
    k = L.eins("bsd,dhk->bshk", x, p["wk"])
    v = L.eins("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if rope:
        q = L.apply_rope(q, sin, cos)
        k = L.apply_rope(k, sin, cos)
    return q, k, v


def apply_attn(p: dict, h: torch.Tensor, dims: Dims, *, sin, cos,
               causal: bool, mode: str = "train",
               cache: Optional[tuple] = None, pos=None, rope: bool = True):
    """Residual self-attention block.

    train/prefill: h [B,S,D]; returns (h', (k, v)) with k/v [B,S,Hkv,dh].
    decode: h [B,1,D]; cache = (k_cache, v_cache) [B,Smax,Hkv,dh]; pos an
    int, the current length. The caches are updated functionally (new
    tensors), as the reference's `dynamic_update_slice`.
    """
    x = L.rmsnorm(h, p["ln"], dims.cfg.norm_eps)
    if mode == "decode":
        q, k_new, v_new = _project_qkv(p, x, dims, sin, cos, rope)
        k_cache, v_cache = cache
        k_cache = k_cache.clone()
        v_cache = v_cache.clone()
        k_cache[:, pos:pos + 1] = k_new.to(k_cache.dtype)
        v_cache[:, pos:pos + 1] = v_new.to(v_cache.dtype)
        new_cache = (k_cache, v_cache)
        out = L.decode_attention(q, k_cache, v_cache, pos + 1, dims.q_group)
    else:
        q, k, v = _project_qkv(p, x, dims, sin, cos, rope)
        # expanded KV for train/prefill, as in the reference; on the card
        # this is the [B·Hq, S, D] layout kernel E takes
        ke, ve = L._expand_kv(k, dims.q_group), L._expand_kv(v, dims.q_group)
        out = L.chunked_attention(q, ke, ve, causal=causal)
        new_cache = (k, v)
    y = L.eins("bshk,hkd->bsd", out, p["wo"])
    return h + y, new_cache


# ==================================================================== MLP

def init_mlp(gen: torch.Generator, d: int, f: int, dims: Dims, device,
             out_scale: float) -> dict:
    pdt = dims.param_dtype
    return {
        "ln": torch.ones((d,), dtype=pdt, device=device),
        "wi": _norm(gen, (d, f), pdt, device),
        "wg": _norm(gen, (d, f), pdt, device),
        "wd": _norm(gen, (f, d), pdt, device, out_scale),
    }


def apply_mlp(p: dict, h: torch.Tensor, dims: Dims) -> torch.Tensor:
    x = L.rmsnorm(h, p["ln"], dims.cfg.norm_eps)
    return h + L.gated_mlp(x, p["wi"], p["wg"], p["wd"])


# ==================================================================== MoE

def init_moe(gen: torch.Generator, dims: Dims, device,
             out_scale: float) -> dict:
    cfg = dims.cfg
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_ff, m.n_experts
    pdt = dims.param_dtype
    p = {
        "ln": torch.ones((d,), dtype=pdt, device=device),
        "router": _norm(gen, (d, e), torch.float32, device),
        "we_i": _norm(gen, (e, d, f), pdt, device),
        "we_g": _norm(gen, (e, d, f), pdt, device),
        "we_o": _norm(gen, (e, f, d), pdt, device, out_scale),
    }
    if m.shared_expert_ff:
        p["shared"] = init_mlp(gen, d, m.shared_expert_ff, dims, device,
                               out_scale)
        del p["shared"]["ln"]  # shares this block's ln
    return p


def _moe_capacity(t: int, m) -> int:
    c = math.ceil(t * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, (c + 7) // 8 * 8)


def _moe_local_body(x, wr, we_i, we_g, we_o, *, moe_cfg, expert_offset,
                    capacity):
    """The MoE math over all tokens and all experts of this card."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    idx, weights, probs = L.moe_route(xf, wr, moe_cfg.top_k)
    slot = L.moe_positions(idx, moe_cfg.n_experts, capacity)
    y = L.moe_apply_local(xf, idx, weights, slot, we_i, we_g, we_o,
                          capacity=capacity, expert_offset=expert_offset)
    aux = L.moe_aux_loss(probs, idx, moe_cfg.n_experts)
    dropped = torch.mean((slot >= capacity).float())
    return y.reshape(b, s, d), aux, dropped


def apply_moe(p: dict, h: torch.Tensor, dims: Dims):
    """MoE block (the reference's no-mesh path). Returns (h', aux_loss,
    dropped_frac)."""
    cfg = dims.cfg
    m = cfg.moe
    x = L.rmsnorm(h, p["ln"], cfg.norm_eps)
    cap = _moe_capacity(x.shape[0] * x.shape[1], m)
    y, aux, dropped = _moe_local_body(
        x, p["router"], p["we_i"], p["we_g"], p["we_o"],
        moe_cfg=m, expert_offset=0, capacity=cap)
    if m.shared_expert_ff:
        sh = p["shared"]
        y = y + L.gated_mlp(x, sh["wi"], sh["wg"], sh["wd"])
    return h + y, aux * m.router_aux_weight, dropped
