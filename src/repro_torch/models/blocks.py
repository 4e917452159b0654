"""Parameter init + apply for the reusable blocks (attention,
cross-attention, MLP, MoE, Mamba2), mirroring `repro/models/blocks.py`.
Model families compose these over a stacked layer axis.

Conventions:
  * params are plain nested dicts of tensors, stacked along a leading
    layer axis by the family code;
  * init draws every random number from the `torch.Generator` it is
    given, on the generator's device (`device`);
  * padded q heads are zero-initialized and masked at init so the padded
    model is numerically identical to the logical one;
  * `mode` is one of 'train' | 'prefill' | 'decode'.

The `*_specs` functions return the reference's logical-axis names of each
block's params (tuples, one name or None an axis). Under a sharding
context (`repro_torch.parallel`) the params are DTensors laid out by
those specs, the activations are constrained with `shd` at the
reference's sites, and `apply_moe` takes its mesh branch, the
counterpart of the reference's `shard_map` body; with no context `shd`
is the identity and `apply_moe` the reference's no-mesh path.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.dims import Dims
from repro_torch.parallel import local_ops
from repro_torch.parallel.sharding import (current_mesh, logical_to_spec,
                                           mesh_axes, mesh_axis_size,
                                           replicated, shd,
                                           spec_to_placements)


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


def attn_specs(dims: Dims) -> dict:
    kv = "kv_heads" if dims.kv_sharded else None
    s = {
        "ln": (None,),
        "wq": ("fsdp", "heads", None),
        "wk": ("fsdp", kv, None),
        "wv": ("fsdp", kv, None),
        "wo": ("heads", None, "fsdp"),
    }
    if dims.cfg.attention.qkv_bias:
        s["bq"] = ("heads", None)
        s["bk"] = (kv, None)
        s["bv"] = (kv, None)
    return s


def stack_specs(tree, depth: int = 1):
    """`tree`'s specs with `depth` leading "stack" axes: the layer axes
    of a stacked layer tree (never sharded)."""
    if isinstance(tree, dict):
        return {k: stack_specs(v, depth) for k, v in tree.items()}
    return ("stack",) * depth + tuple(tree)


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
    kv_ax = "kv_heads" if dims.kv_sharded else None
    q = shd(q, "batch", None, "heads", None)
    k = shd(k, "batch", None, kv_ax, None)
    v = shd(v, "batch", None, kv_ax, None)
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
        k_cache = L.cache_update(k_cache, k_new, pos)
        v_cache = L.cache_update(v_cache, v_new, pos)
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
    if mode != "decode":
        y = shd(y, "batch", "seq", None)
    return h + y, new_cache


def cross_kv(p: dict, memory: torch.Tensor, dims: Dims):
    """Project encoder memory to (k, v) once (reused across decode steps)."""
    dt = memory.dtype
    k = L.eins("bsd,dhk->bshk", memory, p["wk"])
    v = L.eins("bsd,dhk->bshk", memory, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    kv_ax = "kv_heads" if dims.kv_sharded else None
    return shd(k, "batch", None, kv_ax, None), shd(v, "batch", None, kv_ax,
                                                   None)


def apply_cross_attn(p: dict, h: torch.Tensor, dims: Dims, *, kv: tuple,
                     mode: str = "train") -> torch.Tensor:
    """Residual cross-attention: q from h, (k, v) precomputed from memory.
    No RoPE (absolute memory positions). decode: h [B,1,D]; otherwise a
    non-causal `chunked_attention` (kernel E on the card)."""
    x = L.rmsnorm(h, p["ln"], dims.cfg.norm_eps)
    q = L.eins("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = shd(q, "batch", None, "heads", None)
    k, v = kv
    if mode == "decode":
        out = L.decode_attention(q, k, v, k.shape[1], dims.q_group)
    else:
        ke, ve = L._expand_kv(k, dims.q_group), L._expand_kv(v, dims.q_group)
        out = L.chunked_attention(q, ke, ve, causal=False)
    y = L.eins("bshk,hkd->bsd", out, p["wo"])
    if mode != "decode":
        y = shd(y, "batch", "seq", None)
    return h + y


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


def mlp_specs() -> dict:
    return {"ln": (None,), "wi": ("fsdp", "ff"), "wg": ("fsdp", "ff"),
            "wd": ("ff", "fsdp")}


def apply_mlp(p: dict, h: torch.Tensor, dims: Dims,
              seq_shard: bool = True) -> torch.Tensor:
    x = L.rmsnorm(h, p["ln"], dims.cfg.norm_eps)
    y = L.gated_mlp(x, p["wi"], p["wg"], p["wd"])
    if seq_shard:
        y = shd(y, "batch", "seq", None)
    return h + y


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


def moe_specs(dims: Dims) -> dict:
    s = {
        "ln": (None,),
        "router": (None, None),
        "we_i": ("expert", "fsdp", None),
        "we_g": ("expert", "fsdp", None),
        "we_o": ("expert", None, "fsdp"),
    }
    if dims.cfg.moe.shared_expert_ff:
        s["shared"] = {"wi": ("fsdp", "ff"), "wg": ("fsdp", "ff"),
                       "wd": ("ff", "fsdp")}
    return s


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


def apply_moe(p: dict, h: torch.Tensor, dims: Dims, seq_shard: bool = True):
    """Expert-parallel MoE block. Returns (h', aux_loss, dropped_frac).

    With a mesh (`_moe_on_mesh`): tokens stay on their data shard,
    experts are sharded over 'model'; the cross-shard traffic is one sum
    of the combined output over 'model' plus the FSDP all-gather of the
    expert weights over 'data', as the reference's `shard_map` body.
    """
    cfg = dims.cfg
    m = cfg.moe
    x = L.rmsnorm(h, p["ln"], cfg.norm_eps)
    mesh = current_mesh()
    if mesh is None:
        cap = _moe_capacity(x.shape[0] * x.shape[1], m)
        y, aux, dropped = _moe_local_body(
            x, p["router"], p["we_i"], p["we_g"], p["we_o"],
            moe_cfg=m, expert_offset=0, capacity=cap)
    else:
        y, aux, dropped = _moe_on_mesh(p, x, m, mesh)
    if m.shared_expert_ff:
        sh = p["shared"]
        y = y + L.gated_mlp(x, sh["wi"], sh["wg"], sh["wd"])
    if seq_shard:
        y = shd(y, "batch", "seq", None)
    return h + y, aux * m.router_aux_weight, dropped


def _moe_on_mesh(p: dict, x, m, mesh):
    """The reference's `shard_map` MoE body, one local call a rank
    (`parallel.local_ops.run_local`).

    Each rank runs `_moe_local_body` on its data shard's tokens (all of
    them, gathered over 'model') against its 'model' shard's experts,
    all-gathered over 'data' (FSDP). Capacity is the reference's: that of
    one data shard's tokens. The outputs leave as `Partial` sums: y over
    'model' (each rank holds its experts' share), aux and dropped over
    every mesh axis after a division by the mesh size over 'model' and
    the batch ways over 'data', so that resolving them gives the
    reference's psum and pmean. The gradients of inputs that each rank
    reads whole (the router, the tokens over 'model', the weights over
    'data') leave as `Partial` sums for the same reason: each rank's
    gradient covers only its own tokens or experts.
    """
    names = mesh.mesh_dim_names
    ep = mesh_axis_size(mesh, "model")
    bways = 1
    for a in mesh_axes("batch"):
        bways *= mesh_axis_size(mesh, a)
    cap = _moe_capacity((x.shape[0] // bways) * x.shape[1], m)
    expert_offset = mesh.get_local_rank("model") * (m.n_experts // ep)

    def over(axes):
        return [n in axes for n in names]

    tokens = spec_to_placements(names, logical_to_spec(("batch", None, None)))
    experts = spec_to_placements(names, logical_to_spec(("expert", None,
                                                         None)))
    summed = local_ops.summed_where(tokens, over(names))
    y_pl = local_ops.summed_where(tokens, over(("model",)))
    w_grad = local_ops.summed_where(experts, over(mesh_axes("fsdp")))

    def body(x_loc, wr, wei, weg, weo):
        y, aux, dropped = _moe_local_body(
            x_loc, wr, wei, weg, weo, moe_cfg=m,
            expert_offset=expert_offset, capacity=cap)
        return y, aux / (ep * bways), dropped / (ep * bways)

    y, aux, dropped = local_ops.run_local(
        body, (x, p["router"], p["we_i"], p["we_g"], p["we_o"]),
        (tokens, local_ops.without(tokens, (0,)), experts, experts, experts),
        (y_pl, summed, summed), (y_pl, summed, w_grad, w_grad, w_grad))
    return y, replicated(aux), replicated(dropped)


# ================================================================== mamba2

def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=torch.float32)


def init_mamba(gen: torch.Generator, dims: Dims, device,
               out_scale: float) -> dict:
    """The reference's `init_mamba` drawn from `gen`. (The reference draws
    conv_B and conv_C from one key, so they start equal; here each has
    its own draws. The parity tests convert the reference's params.)"""
    cfg = dims.cfg
    s = cfg.ssm
    d, n, w = cfg.d_model, s.d_state, s.d_conv
    di, nh = dims.d_inner, dims.ssm_heads
    nh_logical = s.n_heads(d)
    pdt = dims.param_dtype
    chmask = (torch.arange(di, device=device)
              < nh_logical * s.head_dim).to(pdt)
    hmask = torch.arange(nh, device=device) < nh_logical
    a_init = torch.log(_uniform(gen, (nh,), 1.0, 16.0, device))
    dtb = torch.log(torch.expm1(_uniform(gen, (nh,), 1e-3, 0.1, device)))
    return {
        "ln": torch.ones((d,), dtype=pdt, device=device),
        "wz": _norm(gen, (d, di), pdt, device) * chmask[None, :],
        "wx": _norm(gen, (d, di), pdt, device) * chmask[None, :],
        "wB": _norm(gen, (d, n), pdt, device),
        "wC": _norm(gen, (d, n), pdt, device),
        "wdt": _norm(gen, (d, nh), pdt, device) * hmask[None, :].to(pdt),
        "dt_bias": torch.where(hmask, dtb, -10.0).float(),
        "A_log": torch.where(hmask, a_init, 0.0).float(),
        "Dres": torch.where(hmask, 1.0, 0.0).float(),
        "conv_x": _norm(gen, (di, w), pdt, device, 0.5) * chmask[:, None],
        "conv_B": _norm(gen, (n, w), pdt, device, 0.5),
        "conv_C": _norm(gen, (n, w), pdt, device, 0.5),
        "norm_w": torch.ones((di,), dtype=pdt, device=device),
        "wo": _norm(gen, (di, d), pdt, device, out_scale) * chmask[:, None],
    }


def mamba_specs() -> dict:
    return {
        "ln": (None,), "wz": ("fsdp", "ff"), "wx": ("fsdp", "ff"),
        "wB": ("fsdp", None), "wC": ("fsdp", None), "wdt": ("fsdp", "heads"),
        "dt_bias": ("heads",), "A_log": ("heads",), "Dres": ("heads",),
        "conv_x": ("ff", None), "conv_B": (None, None), "conv_C": (None, None),
        "norm_w": ("ff",), "wo": ("ff", "fsdp"),
    }


def mamba_decode_state_specs() -> dict:
    """Logical axes of one stacked Mamba decode state (`mamba_state_shapes`
    with the layer axis)."""
    return {
        "ssd": ("stack", "batch", "heads", None, None),
        "conv_x": ("stack", "batch", "ff", None),
        "conv_B": ("stack", "batch", None, None),
        "conv_C": ("stack", "batch", None, None),
    }


def _mamba_project(p, x, dims: Dims):
    z = L.eins("bsd,de->bse", x, p["wz"])
    xin = L.eins("bsd,de->bse", x, p["wx"])
    b_in = L.eins("bsd,dn->bsn", x, p["wB"])
    c_in = L.eins("bsd,dn->bsn", x, p["wC"])
    dt = L.eins("bsd,dh->bsh", x, p["wdt"])
    return z, xin, b_in, c_in, dt


def _silu_as(x: torch.Tensor) -> torch.Tensor:
    """silu in float32, cast back to x's dtype."""
    return F.silu(x.float()).to(x.dtype)


def apply_mamba(p: dict, h: torch.Tensor, dims: Dims, *,
                return_state: bool = False):
    """Mamba2 block, train/prefill path (chunked SSD: kernel F on the
    card). h: [B,S,D].

    Returns (h', state): with return_state, `state` is the decode state
    (ssd + conv tails) so prefill can hand off to decode_step; without,
    the SSD's final state alone, as the reference returns it.
    """
    cfg = dims.cfg
    s = cfg.ssm
    nh_logical = s.n_heads(cfg.d_model)
    x = L.rmsnorm(h, p["ln"], cfg.norm_eps)
    x = shd(x, "batch", None, None)
    z, xin_raw, b_raw, c_raw, dt = _mamba_project(p, x, dims)
    xin = _silu_as(L.causal_depthwise_conv(xin_raw, p["conv_x"]))
    b_in = _silu_as(L.causal_depthwise_conv(b_raw, p["conv_B"]))
    c_in = _silu_as(L.causal_depthwise_conv(c_raw, p["conv_C"]))
    xin = shd(xin, "batch", None, "ff")
    bsz, seq = xin.shape[:2]
    xh = xin.reshape(bsz, seq, dims.ssm_heads, s.head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, last_state = L.ssd_chunked(xh, dt, A, b_in, c_in, p["Dres"], s.chunk)
    y = y.reshape(bsz, seq, dims.d_inner)
    y = L.gated_rmsnorm(y, z, p["norm_w"], cfg.norm_eps,
                        n=nh_logical * s.head_dim)
    out = shd(L.eins("bse,ed->bsd", y, p["wo"]), "batch", "seq", None)
    new_h = h + out
    if not return_state:
        return new_h, last_state
    w = s.d_conv

    def tail(t):                          # the last W-1 inputs, [B,C,W-1]
        return t[:, -(w - 1):, :].transpose(1, 2).float()

    return new_h, {"ssd": last_state, "conv_x": tail(xin_raw),
                   "conv_B": tail(b_raw), "conv_C": tail(c_raw)}


def mamba_state_shapes(dims: Dims, batch: int, device="cuda") -> dict:
    """Zero decode state for ONE mamba layer."""
    s = dims.cfg.ssm

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"ssd": z(batch, dims.ssm_heads, s.head_dim, s.d_state),
            "conv_x": z(batch, dims.d_inner, s.d_conv - 1),
            "conv_B": z(batch, s.d_state, s.d_conv - 1),
            "conv_C": z(batch, s.d_state, s.d_conv - 1)}


def _conv_step(state: torch.Tensor, xt: torch.Tensor, w: torch.Tensor):
    """state [B,C,W-1], xt [B,C], w [C,W] -> (y [B,C], new_state)."""
    full = torch.cat([state, xt[:, :, None].to(state.dtype)], dim=2)
    y = torch.einsum("bcw,cw->bc", full, w.to(state.dtype))
    return y.to(xt.dtype), full[:, :, 1:]


def apply_mamba_decode(p: dict, h: torch.Tensor, dims: Dims, state: dict):
    """One-token mamba step (plain torch). h: [B,1,D]; state from
    mamba_state_shapes. Returns (h', new_state)."""
    cfg = dims.cfg
    s = cfg.ssm
    nh_logical = s.n_heads(cfg.d_model)
    x = L.rmsnorm(h, p["ln"], cfg.norm_eps)
    z, xin, b_in, c_in, dt = _mamba_project(p, x, dims)
    xt, conv_x = _conv_step(state["conv_x"], xin[:, 0], p["conv_x"])
    bt, conv_B = _conv_step(state["conv_B"], b_in[:, 0], p["conv_B"])
    ct, conv_C = _conv_step(state["conv_C"], c_in[:, 0], p["conv_C"])
    xh = _silu_as(xt).reshape(-1, dims.ssm_heads, s.head_dim)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, ssd = L.ssd_decode_step(xh, dtv, A, _silu_as(bt), _silu_as(ct),
                               p["Dres"], state["ssd"])
    y = y.reshape(-1, 1, dims.d_inner)
    y = L.gated_rmsnorm(y, z, p["norm_w"], cfg.norm_eps,
                        n=nh_logical * s.head_dim)
    out = torch.einsum("bse,ed->bsd", y, p["wo"].to(y.dtype))
    return h + out, {"ssd": ssd, "conv_x": conv_x, "conv_B": conv_B,
                     "conv_C": conv_C}
