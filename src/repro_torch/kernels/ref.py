"""Plain PyTorch oracles for the float kernels (the allclose targets),
written as `repro/kernels/ref.py` of the JAX package writes them."""
from __future__ import annotations

import math

import torch


def flash_attention(q, k, v, *, causal: bool = True):
    """q/k/v: [BH, S, D] (kv already GQA-expanded). fp32 softmax."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        i64 = dict(dtype=torch.int64, device=q.device)
        mask = (torch.arange(sq, **i64)[:, None]
                >= torch.arange(sk, **i64)[None, :])
        s = torch.where(mask[None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def kv_quant(pages):
    """pages: [P, T, H, D] float -> (int8 [P,T,H,D], scale [P,H])."""
    x = pages.float()
    amax = x.abs().amax(dim=(1, 3))
    # a tensor divisor: on CUDA, torch divides by a Python scalar through
    # its reciprocal, one rounding away from the true division
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(x / scale[:, None, :, None])      # half to even
    return q.clamp(-127, 127).to(torch.int8), scale


def paged_decode_attention(q, k_pages, v_pages, k_scale, v_scale,
                           page_table, seq_lens, *, page_size: int):
    """Decode attention over an int8 paged KV cache (per-sequence).

    q: [B, H, D]; *_pages: [P, T, Hkv, D] int8; *_scale: [P, Hkv];
    page_table: [B, MAXP] int32; seq_lens: [B]. GQA by head repeat.
    """
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    group = h // hkv
    outs = []
    for bi in range(b):
        n = int(seq_lens[bi])
        ks, vs = [], []
        for pi in range((n + page_size - 1) // page_size):
            p = int(page_table[bi, pi])
            ks.append(k_pages[p].float() * k_scale[p][None, :, None])
            vs.append(v_pages[p].float() * v_scale[p][None, :, None])
        zeros = torch.zeros((0, hkv, d), dtype=torch.float32,
                            device=q.device)
        k = torch.cat(ks, 0)[:n] if ks else zeros
        v = torch.cat(vs, 0)[:n] if vs else zeros
        if group > 1:
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        s = torch.einsum("hd,shd->hs", q[bi].float(), k) / math.sqrt(d)
        outs.append(torch.einsum("hs,shd->hd", torch.softmax(s, dim=-1), v))
    return torch.stack(outs).to(q.dtype)


def mamba2_ssd(x, dt, A, B_in, C_in, *, chunk: int):
    """SSD chunked scan oracle. x: [B,S,H,P]; dt: [B,S,H] (>0, post-softplus);
    A: [H] (<0); B_in/C_in: [B,S,N] or [B,S,G,N] (G groups of H/G heads).
    Returns y [B,S,H,P] (no D residual)."""
    return mamba2_ssd_with_state(x, dt, A, B_in, C_in, chunk=chunk)[0]


def mamba2_ssd_with_state(x, dt, A, B_in, C_in, *, chunk: int):
    """`mamba2_ssd` and the final state [B,H,P,N] float32 (the port's own
    oracle: `ssd_chunked`'s two outputs with a zero residual)."""
    from repro_torch.models.layers import ssd_chunked_plain
    return ssd_chunked_plain(x, dt, A, B_in, C_in,
                             torch.zeros(A.shape, dtype=torch.float32,
                                         device=A.device), chunk)
