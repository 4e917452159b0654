"""Core layers, mirroring `repro/models/layers.py`: RMSNorm, RoPE/M-RoPE,
GQA attention (chunked online softmax), gated MLP, MoE with sort-based
capacity dispatch, and the Mamba2 SSD scan.

All functions are pure functions of tensors. Compute happens in the
inputs' dtype with float32 softmax/norm accumulators, as in the reference.
Activations carry the reference's logical-axis annotations
(`repro_torch.parallel.shd`), no-ops without a sharding context.

`chunked_attention` is where kernel E enters the model, and
`ssd_chunked` where kernel F does: on CUDA tensors they launch
`repro_torch.kernels.flash_attention` / `mamba2_ssd` (or raise), on CPU
tensors they run the reference's loops (`chunked_attention_plain`,
`ssd_chunked_plain`, the latter also F's oracle), and so on `meta`
tensors, which carry shapes only (the dry run, `repro_torch.launch.dryrun`,
as the reference's lowers its models' plain path); any other device
raises. On the card both launches sit inside
`torch.autograd.Function`s (`kernels.ops`): E's backward is its own
kernels (from the forward's saved output and log-sum-exp), F's is
autograd of the plain version recomputed from the saved inputs, as the
reference's `flash_attention_trainable` differentiates its kernel: the
kernel runs every forward, a gradient passes through it. On DTensors (a sharding
context) both run through `local_map` on each rank's local heads
(`_attention_on_mesh`, `_ssd_on_mesh`): the same function of the local
shards, kernel or plain by the shards' device. The other Mamba2 layers
(depthwise conv, the one-token SSD step, the gated norm) are plain torch
on every device, as they are plain jnp in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.kernels import ops as _ops
from repro_torch.parallel import local_ops
from repro_torch.parallel.sharding import (is_dtensor, logical_to_spec,
                                           mesh_axes, shd,
                                           spec_to_placements, unshard)

#: devices whose tensors take the plain route: the CPU, and `meta`, which
#: computes shapes only and whose values are never read
PLAIN_DEVICES = ("cpu", "meta")

# --------------------------------------------------------------------- norms

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float,
            n: Optional[int] = None) -> torch.Tensor:
    """RMSNorm with an explicit logical divisor `n` (padded channels are zero,
    so summing over the padded dim but dividing by the logical count keeps the
    math identical to the unpadded model)."""
    dtype = x.dtype
    x = x.float()
    denom = n if n is not None else x.shape[-1]
    var = torch.sum(x * x, dim=-1, keepdim=True) / denom
    y = x * torch.rsqrt(var + eps)
    return (y * w.float()).to(dtype)


# ----------------------------------------------------------------- embedding

def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """`table[tokens]`, the reference's `jnp.take(table, tokens, axis=0)`.
    On a DTensor table, each rank looks its own tokens up in the whole
    table, gathered over its vocab rows and its d_model columns (DTensor's
    row-sharded lookup would rely on a masked partial sum, and its index
    backward is not in every release); the table's gradient is a sum over
    the tokens' ranks."""
    if not is_dtensor(table):
        return table[tokens.long()]
    ids = (list(tokens.placements) if is_dtensor(tokens)
           else [Replicate()] * table.device_mesh.ndim)
    ids = local_ops.without(ids, range(1, tokens.ndim))
    whole = [Replicate()] * len(ids)
    (out,) = local_ops.run_local(
        lambda t, i: (t[i.long()],), (table, tokens), (whole, ids), (ids,),
        (local_ops.summed_where(whole, [p.is_shard() for p in ids]), ids))
    return out


# ---------------------------------------------------------------------- rope

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[tuple] = None):
    """sin/cos tables. positions: [B, S] or [3, B, S] for M-RoPE.

    M-RoPE (Qwen2-VL): the head_dim/2 frequency channels are split into
    (t, h, w) sections; section i uses position stream i.
    """
    half = head_dim // 2
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=dev) / half))
    pos = positions.float()
    if positions.ndim == 3:
        assert mrope_sections is not None and sum(mrope_sections) == half
        angles3 = pos[..., None] * inv_freq[None, None, None, :]   # [3,B,S,half]
        # channel c belongs to section i where starts[i] <= c < ends[i];
        # comparisons with ints dispatch the same ops on every device
        # (`one_hot` checks its input's range on the host, not on meta)
        idx = torch.arange(half, device=dev)
        ends = [sum(mrope_sections[:i + 1]) for i in range(3)]
        starts = [0] + ends[:2]
        onehot = torch.stack([(idx >= lo) & (idx < hi) for lo, hi in
                              zip(starts, ends)], dim=1).float()   # [half,3]
        angles = torch.einsum("tbsh,ht->bsh", angles3, onehot)
    else:
        angles = pos[..., None] * inv_freq[None, None, :]          # [B,S,half]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; sin/cos: [B, S, D/2]. Split-half convention."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(dtype)


# ----------------------------------------------------------------- attention

def _expand_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    """[B,S,Hkv,D] -> [B,S,Hkv*group,D] by repeating each kv head. On a
    DTensor, each rank repeats its own kv heads: those of its q heads'
    groups when the kv heads are sharded, all of them when replicated."""
    if group == 1:
        return k
    if is_dtensor(k):
        pl = local_ops.without(k.placements, (1, 3))
        (out,) = local_ops.run_local(lambda x: (_expand_kv(x, group),),
                                     (k,), (pl,), (pl,))
        return out
    b, s, hkv, d = k.shape
    k = k[:, :, :, None, :].expand(b, s, hkv, group, d)
    return k.reshape(b, s, hkv * group, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_block: int = 1024, kv_block: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """GQA attention. q: [B,Sq,Hq,D]; k/v: [B,Skv,Hkv,D]. Returns [B,Sq,Hq,D].

    On CUDA tensors: kernel E (`_flash_on_card`), which raises where it
    cannot compute the same function. On CPU tensors, and on `meta`
    tensors (shapes only: the dry run), `chunked_attention_plain`.
    """
    if is_dtensor(q):
        return _attention_on_mesh(q, k, v, causal=causal, q_block=q_block,
                                  kv_block=kv_block, q_offset=q_offset)
    if q.device.type == "cuda":
        return _flash_on_card(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type not in PLAIN_DEVICES:
        raise ValueError(f"chunked_attention: unsupported device {q.device}")
    return chunked_attention_plain(q, k, v, causal=causal, q_block=q_block,
                                   kv_block=kv_block, q_offset=q_offset)


def _on_local_shards(fn, args, specs, out_specs, summed=None):
    """`fn` on each rank's local shards of the DTensors `args`, laid out
    by the logical axes `specs` (one tuple an argument), its outputs
    DTensors of `out_specs` (`parallel.local_ops.run_local`). `summed`
    maps an argument's position to a logical axis: that argument is read
    whole on the axis' mesh dimensions while each rank works on its own
    share of them, so its gradient is a `Partial` sum there."""
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    names = mesh.mesh_dim_names

    def placements(axes):
        return spec_to_placements(names, logical_to_spec(axes))

    ins = [placements(a) for a in specs]
    grads = list(ins)
    for i, axis in (summed or {}).items():
        grads[i] = local_ops.summed_where(
            ins[i], [n in mesh_axes(axis) for n in names])
    return local_ops.run_local(fn, args, ins,
                               [placements(a) for a in out_specs], grads)


def _attention_on_mesh(q, k, v, **kw):
    """`chunked_attention` on DTensors: each rank attends over its batch
    shard's local heads. K and V come expanded to the q heads (as every
    caller passes them, GQA's `_expand_kv`), so a rank's slice of them
    holds the kv heads of its own q heads' groups, whether the kv heads
    were sharded or replicated."""
    heads = ("batch", None, "heads", None)
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"chunked_attention on a mesh takes K/V expanded "
                         f"to the q heads: {tuple(k.shape)} vs "
                         f"{tuple(q.shape)}")
    (out,) = _on_local_shards(
        lambda a, b, c: (chunked_attention(a, b, c, **kw),), (q, k, v),
        (heads,) * 3, (heads,))
    return out


def chunked_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool,
                            q_block: int = 1024, kv_block: int = 1024,
                            q_offset: int = 0) -> torch.Tensor:
    """`chunked_attention` as the reference computes it, on any device:
    its memory-bounded form, an online softmax over KV blocks looped over
    Q blocks, KV unexpanded and q heads grouped [B,Sq,Hkv,G,D]."""
    dev = q.device
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    assert sq % q_block == 0 and skv % kv_block == 0
    scale = 1.0 / math.sqrt(d)
    nq, nk = sq // q_block, skv // kv_block

    # [nq,B,Hkv,G,qb,D] / [nk,B,Hkv,kb,D]
    qr = q.reshape(b, nq, q_block, hkv, g, d).permute(1, 0, 3, 4, 2, 5)
    kr = k.reshape(b, nk, kv_block, hkv, d).permute(1, 0, 3, 2, 4)
    vr = v.reshape(b, nk, kv_block, hkv, d).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        qblk = qr[qi].float() * scale
        m = torch.full((b, hkv, g, q_block), -torch.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, q_block), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((b, hkv, g, q_block, d), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kr[ki].float())
            if causal:
                qpos = q_offset + qi * q_block + torch.arange(
                    q_block, dtype=torch.int64, device=dev)
                kpos = ki * kv_block + torch.arange(
                    kv_block, dtype=torch.int64, device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            # guard fully-masked rows (m_new == -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vr[ki].float())
            m = m_new
        outs.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    # [nq,B,Hkv,G,qb,D] -> [B,Sq,Hq,D]
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, sq, hq, d)


def last_position(h: torch.Tensor) -> torch.Tensor:
    """h[:, -1]: [B,S,D] -> [B,D], the sequence gathered first on a
    DTensor (a select of one position of a sharded dimension)."""
    return unshard(h, 1)[:, -1]


def _flash_on_card(q, k, v, *, causal: bool, q_offset: int):
    """`chunked_attention` on the card: kernel E on [B·Hq, S, D], K/V
    expanded to the q heads, through `flash_attention_ragged`, which
    takes every length the reference does (q padded at the end to E's
    128-row blocks and sliced back, keys at their own length), causal or
    not: the encoder's and cross-attention's non-causal calls and the
    decoders' causal ones. E counts query positions from 0: a `q_offset`
    raises `ValueError`. Differentiable:
    `ops.flash_attention_ragged_trainable` (E forward, E's backward
    kernels); the GQA expansion and the permutes stay outside
    it, under autograd, so the repeated kv heads' gradients are summed."""
    b, sq, hq, d = q.shape
    if q_offset:
        raise ValueError(f"chunked_attention: kernel E counts query "
                         f"positions from 0; q_offset={q_offset} is not "
                         f"supported on the card")
    group = hq // k.shape[2]
    k, v = _expand_kv(k, group), _expand_kv(v, group)

    def heads_first(x):                  # [B,S,H,D] -> [B·H, S, D]
        return x.permute(0, 2, 1, 3).reshape(b * hq, x.shape[1],
                                             d).contiguous()

    out = _ops.flash_attention_ragged_trainable(
        heads_first(q), heads_first(k), heads_first(v), causal=causal)
    return out.reshape(b, hq, sq, d).permute(0, 2, 1, 3)


def cache_update(cache: torch.Tensor, new: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """`cache` [B,Smax,H,D] with position `pos` set to `new` [B,1,H,D], as
    a new tensor (the reference's `dynamic_update_slice`). A DTensor
    cache, whose positions may be sharded ('pages'), is written with an
    elementwise select: a slice assignment would write into a
    redistributed copy of it."""
    new = new.to(cache.dtype)
    if is_dtensor(cache):
        at = torch.arange(cache.shape[1], device=new.device) == pos
        return torch.where(at[None, :, None, None], new, cache)
    cache = cache.clone()
    cache[:, pos:pos + 1] = new
    return cache


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len, group: int) -> torch.Tensor:
    """Single-token attention against a dense KV cache, plain torch on
    every device (the reference computes it in jnp too).

    q: [B,1,Hq,D]; caches: [B,Smax,Hkv,D]. KV is never head-expanded: q is
    grouped to [B,Hkv,G,D]. On DTensors each rank attends for its batch
    shard over every head and the whole cache (gathered over 'pages').
    """
    if is_dtensor(q):
        pl = local_ops.without(q.placements, (1, 2, 3))
        (out,) = local_ops.run_local(
            lambda a, kc, vc: (decode_attention(a, kc, vc, cur_len, group),),
            (q, k_cache, v_cache), (pl, pl, pl), (pl,))
        return out
    b, _, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qr = q[:, 0].reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(),
                     k_cache.float()) / math.sqrt(d)
    mask = torch.arange(smax, device=q.device)[None, None, None, :] < cur_len
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


# --------------------------------------------------------------- dense  MLP

def eins(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with the result in a's dtype (b cast to it). On a DTensor
    `a`, one local einsum a rank (`parallel.local_ops.einsum`)."""
    if is_dtensor(a):
        return local_ops.einsum(spec, a, b, lambda x, w: torch.einsum(
            spec, x, w.to(x.dtype)))
    return torch.einsum(spec, a, b.to(a.dtype))


def gated_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
              wd: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP. x: [B,S,D]; wi/wg: [D,F]; wd: [F,D]."""
    h = eins("bsd,df->bsf", x, wi)
    g = eins("bsd,df->bsf", x, wg)
    h = h * F.silu(g.float()).to(x.dtype)
    h = shd(h, "batch", None, "ff")
    return eins("bsf,fd->bsd", h, wd)


# ---------------------------------------------------------------------- MoE

def moe_route(x_flat: torch.Tensor, wr: torch.Tensor, top_k: int):
    """Router: returns (expert_idx [T,k], weights [T,k] fp32, probs [T,E])."""
    logits = torch.einsum("td,de->te", x_flat.float(), wr.float())
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    return idx, weights, probs


def moe_positions(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """Sort-based intra-expert slot assignment (no [T,E,C] one-hots).

    expert_idx: [T, k]. Returns slot [T, k] (position within expert,
    >= capacity means dropped).
    """
    t, k = expert_idx.shape
    flat = expert_idx.reshape(-1)                                # [T*k]
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    # start offset of each expert segment in the sorted order
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=flat.device), side="left")
    pos_sorted = torch.arange(t * k, device=flat.device) - starts[sorted_e]
    slot = torch.zeros_like(flat).scatter(0, order, pos_sorted)
    return slot.reshape(t, k)


def moe_apply_local(x_flat: torch.Tensor, expert_idx: torch.Tensor,
                    weights: torch.Tensor, slot: torch.Tensor,
                    we_i: torch.Tensor, we_g: torch.Tensor,
                    we_o: torch.Tensor, *, capacity: int, expert_offset: int):
    """Compute `E_loc` experts' contribution for the tokens.

    x_flat [T,D]; we_*: [E_loc, D, F] / [E_loc, F, D]. Tokens routed to
    experts outside [expert_offset, expert_offset + E_loc) or beyond
    capacity contribute zero.
    """
    t, d = x_flat.shape
    e_loc = we_i.shape[0]
    k = expert_idx.shape[1]
    local_e = expert_idx - expert_offset                        # [T,k]
    valid = (local_e >= 0) & (local_e < e_loc) & (slot < capacity)
    e_idx = torch.where(valid, local_e, 0).reshape(-1)
    s_idx = torch.where(valid, slot, capacity - 1).reshape(-1)
    # scatter tokens into capacity buffers [E_loc, C, D]
    buf = torch.zeros((e_loc, capacity, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    tok = x_flat[:, None, :].expand(t, k, d)
    upd = torch.where(valid[..., None], tok, 0).reshape(-1, d)
    buf = buf.index_put((e_idx, s_idx), upd, accumulate=True)
    # expert FFN, batched over local experts
    h = eins("ecd,edf->ecf", buf, we_i)
    g = eins("ecd,edf->ecf", buf, we_g)
    h = h * F.silu(g.float()).to(h.dtype)
    out = eins("ecf,efd->ecd", h, we_o)
    # gather back, weighted
    picked = out[e_idx, s_idx].reshape(t, k, d)
    picked = picked * (weights.to(picked.dtype)[..., None]
                       * valid[..., None].to(picked.dtype))
    return picked.sum(dim=1)                                    # [T, D]


def moe_aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                 n_experts: int) -> torch.Tensor:
    """Switch/GShard load-balance loss: E * sum_e f_e * p_e."""
    f = torch.zeros((n_experts,), device=probs.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.ones(expert_idx.numel(), device=probs.device))
    f = f / max(expert_idx.numel(), 1)
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


# -------------------------------------------------------------------- mamba2

def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over the sequence. x: [B,S,C]; w: [C,W]. On
    a DTensor, each rank convolves its batch shard's local channels
    over the whole sequence."""
    if is_dtensor(x):
        px = local_ops.without(x.placements, (1,))
        pw = [Shard(0) if p == Shard(2) else Replicate() for p in px]
        (out,) = local_ops.run_local(
            lambda a, b: (causal_depthwise_conv(a, b),), (x, w), (px, pw),
            (px,), (px, local_ops.summed_where(pw, [p == Shard(0)
                                                    for p in px])))
        return out
    width = w.shape[-1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        shift = width - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xi.float() * w[:, i].float()
    return out.to(x.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_in: torch.Tensor, C_in: torch.Tensor, D_res: torch.Tensor,
                chunk: int, init_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD (state-space duality), chunked.

    x: [B,S,H,P]; dt: [B,S,H] (post-softplus, >0); A: [H] (negative);
    B_in/C_in: [B,S,N] (one group) or [B,S,G,N] (G groups, each read by
    H/G consecutive heads); D_res: [H].
    Returns y [B,S,H,P] and final state [B,H,P,N].

    On CUDA tensors: kernel F (`_ssd_on_card`), which raises where it
    cannot compute the same function. On CPU and `meta` tensors: the
    reference's chunked form, `ssd_chunked_plain`.
    """
    if is_dtensor(x):
        if B_in.ndim == 4:
            raise ValueError("ssd_chunked: B/C groups are not supported on "
                             "a mesh")
        return _ssd_on_mesh(x, dt, A, B_in, C_in, D_res, chunk, init_state)
    if x.device.type == "cuda":
        return _ssd_on_card(x, dt, A, B_in, C_in, D_res, chunk, init_state)
    if x.device.type not in PLAIN_DEVICES:
        raise ValueError(f"ssd_chunked: unsupported device {x.device}")
    return ssd_chunked_plain(x, dt, A, B_in, C_in, D_res, chunk, init_state)


def _ssd_on_mesh(x, dt, A, B_in, C_in, D_res, chunk, init_state):
    """`ssd_chunked` on DTensors: each rank scans its batch shard's local
    SSD heads. B and C (one group) are read whole by every head, so
    their gradient is a sum over the heads' ranks; A's and D's over the
    batch's."""
    xs, hs = ("batch", None, "heads", None), ("batch", None, "heads")
    ns, state = ("batch", None, None), ("batch", "heads", None, None)
    specs = [xs, hs, ("heads",), ns, ns, ("heads",)]
    args = [x, dt, A, B_in, C_in, D_res]
    if init_state is not None:
        specs.append(state)
        args.append(init_state)

    def local(*a):
        return ssd_chunked(*a[:6], chunk, a[6] if len(a) > 6 else None)

    return _on_local_shards(local, tuple(args), tuple(specs), (xs, state),
                            summed={2: "batch", 3: "heads", 4: "heads",
                                    5: "batch"})


def _ssd_on_card(x, dt, A, B_in, C_in, D_res, chunk, init_state):
    """`ssd_chunked` on the card: kernel F's y and final state on the
    inputs cast to float32 (the reference computes in float32 inside),
    `D_res·x` added in float32, y cast back to x's dtype. F starts every
    sequence from a zero state: an `init_state` raises `ValueError` (no
    model passes one). Differentiable: `ops.mamba2_ssd_with_state_trainable`
    (F forward, the plain SSD's gradient backward); `D_res·x` stays
    outside it."""
    if init_state is not None:
        raise ValueError("ssd_chunked: kernel F starts from a zero state; "
                         "init_state is not supported on the card")
    xf = x.float().contiguous()
    y, state = _ops.mamba2_ssd_with_state_trainable(
        xf, dt.float().contiguous(), A.float().contiguous(),
        B_in.float().contiguous(), C_in.float().contiguous(), chunk=chunk)
    y = y + D_res.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def ssd_chunked_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B_in: torch.Tensor, C_in: torch.Tensor,
                      D_res: torch.Tensor, chunk: int,
                      init_state: Optional[torch.Tensor] = None):
    """`ssd_chunked` as the reference computes it, on any device: the
    plain version kernel F is held to (`kernels.ref.mamba2_ssd`).

    B_in/C_in [B,S,G,N] give G groups: head h reads group h // (H/G),
    and each group's heads are scanned by the one-group form below on
    their slices (G = 1 is that form on the whole tensors).

    One departure from the reference: the decay's exponent cum_i - cum_j
    is set to -inf above the diagonal before the exp. The reference takes
    the exp first and masks after; above the diagonal the exponent is
    positive and overflows once |dt·A| summed over a chunk passes ~88,
    and the masked product's gradient is then 0·inf = NaN. The values
    are the same either way; the gradients here stay finite."""
    if B_in.ndim == 4:
        g = B_in.shape[2]
        hg = x.shape[2] // g
        if g * hg != x.shape[2]:
            raise ValueError(f"ssd_chunked: {g} groups do not divide "
                             f"{x.shape[2]} heads")
        outs = [ssd_chunked_plain(
            x[:, :, i * hg:(i + 1) * hg], dt[:, :, i * hg:(i + 1) * hg],
            A[i * hg:(i + 1) * hg], B_in[:, :, i], C_in[:, :, i],
            D_res[i * hg:(i + 1) * hg], chunk,
            None if init_state is None
            else init_state[:, i * hg:(i + 1) * hg]) for i in range(g)]
        if g == 1:
            return outs[0]
        return (torch.cat([o[0] for o in outs], 2),
                torch.cat([o[1] for o in outs], 1))
    b, s, h, p = x.shape
    n = B_in.shape[-1]
    l = min(chunk, s)
    assert s % l == 0
    nc = s // l
    xc = x.reshape(b, nc, l, h, p)
    dtc = dt.reshape(b, nc, l, h).float()
    bc = B_in.reshape(b, nc, l, n).float()
    cc = C_in.reshape(b, nc, l, n).float()
    dA = dtc * A.float()[None, None, None, :]                    # [B,nc,L,H] (<0)
    cum = torch.cumsum(dA, dim=2)                                # within-chunk
    total = cum[:, :, -1:, :]                                    # [B,nc,1,H]
    dtx = dtc[..., None] * xc.float()                            # [B,nc,L,H,P]

    # ---- intra-chunk (quadratic within chunk, causal-masked decay)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)                 # [B,nc,L,L]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(
        mask[None, None, :, :, None],
        cum[:, :, :, None, :] - cum[:, :, None, :, :], -torch.inf))
    w_ij = torch.where(mask[None, None, :, :, None], cb[..., None] * decay,
                       0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_ij, dtx)

    # ---- inter-chunk: end-of-chunk states, then a sequential scan over chunks
    decay_to_end = torch.exp(total - cum)                        # [B,nc,L,H]
    states = torch.einsum("bclh,bcln,bclhp->bchpn", decay_to_end, bc, dtx)
    chunk_decay = torch.exp(total[:, :, 0, :])                   # [B,nc,H]

    hstate = (init_state.float() if init_state is not None
              else torch.zeros((b, h, p, n), device=x.device))
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, 1)                              # [B,nc,H,P,N]
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", cc, torch.exp(cum),
                           hprevs)

    y = y_intra + y_inter + (D_res.float()[None, None, None, :, None]
                             * xc.float())
    return y.reshape(b, s, h, p).to(x.dtype), hstate


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B_in: torch.Tensor, C_in: torch.Tensor,
                    D_res: torch.Tensor, state: torch.Tensor):
    """One-token SSD recurrence. x:[B,H,P]; dt:[B,H]; B_in/C_in:[B,N];
    state:[B,H,P,N] fp32. Returns (y [B,H,P], new_state)."""
    dtf = dt.float()
    dA = torch.exp(dtf * A.float()[None, :])                     # [B,H]
    dBx = torch.einsum("bh,bn,bhp->bhpn", dtf, B_in.float(), x.float())
    new_state = state * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C_in.float(), new_state)
    y = y + D_res.float()[None, :, None] * x.float()
    return y.to(x.dtype), new_state


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float, n: Optional[int] = None,
                  groups: int = 1) -> torch.Tensor:
    """Mamba2 output norm: RMSNorm(y * silu(z)); with `groups`, taken over
    each of that many equal slices of the channels apart."""
    yf = y.float() * F.silu(z.float())
    if groups > 1:
        yg = yf.reshape(*yf.shape[:-1], groups, -1)
        var = torch.mean(yg * yg, dim=-1, keepdim=True)
        yg = yg * torch.rsqrt(var + eps)
        return (yg.reshape(yf.shape) * w.float()).to(y.dtype)
    denom = n if n is not None else yf.shape[-1]
    var = torch.sum(yf * yf, dim=-1, keepdim=True) / denom
    if is_dtensor(var):                   # a sum over sharded channels
        var = var.redistribute(var.device_mesh,
                               local_ops.without(var.placements, ()))
    return (yf * torch.rsqrt(var + eps) * w.float()).to(y.dtype)
