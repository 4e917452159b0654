"""Decode attention over an int8 paged KV cache, with the dequantization
fused into the page loop, as a CUDA kernel (kernel C).

Replaces the TPU kernel `_paged_kernel` of the JAX package
(`repro/kernels/refresh_paged_attention.py`): for each sequence `b` and
query head `h`, attend `q[b, h]` over the first `seq_lens[b]` positions
of the sequence's pages (`page_table[b]`, entries clamped at 0), each
int8 page dequantized by its per-(page, kv head) scale as it is read.
Query head `h` reads kv head `h // group`; q is scaled by `1/sqrt(D)`
before the dot; masked scores are -1e30; pages at or past
`ceil(seq_len / T)` are skipped, so a sequence of length 0 gets zeros
(`acc / max(l, 1e-30)`), as the TPU kernel gives.

Beside the kernel, as beside every kernel of this package:

  * `paged_attention_torch` is the plain PyTorch version: every page of
    the table gathered and dequantized at once, the same mask, softmax
    and zero-length rule;
  * `refresh_paged_attention` is the wrapper around the hand-written
    kernel `paged_attention_kernel` (`csrc/refresh_paged_attention.cu`).
    It takes the plain version only for tensors that lie on the CPU (or
    on `meta`, shapes only); for CUDA tensors it launches the kernel or
    raises;
  * `LAUNCHES` is a plain integer, incremented where the kernel is
    launched and nowhere else.

What bounds it on an H100: bytes. A decode step reads each valid row's
int8 K and V once (plus two scales a page) and does about 4 operations a
byte, far under the card's ~295 a byte. The design keeps the fused
property of the TPU kernel, which is the point of it: int8 is loaded and
dequantized inside the page loop and no dequantized cache is written to
device memory (`ops.paged_attention_serial` is the unfused baseline).
A decode step has few (sequence, kv head) pairs, so a sequence's pages
are split over blocks, `SPLIT_PAGES` a block (flash-decoding): each
block stages its pages' K and V rows for its kv head through a
shared-memory ring filled by `cp.async` and keeps an online softmax for
up to 8 of the kv head's query heads (a wider group, as Qwen3-MoE's 16,
takes more blocks); a second launch merges the splits' partial states.
One call of the wrapper counts as one launch; it allocates the partial
states' scratch.
"""
from __future__ import annotations

import math

import torch

#: number of kernel launches made by `refresh_paged_attention`
LAUNCHES = 0

#: the widest head the kernel takes
MAX_D = 128

#: pages of a sequence a block takes
SPLIT_PAGES = 8

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
NEG_INF = -1e30


def paged_attention_torch(q, k_pages, v_pages, k_scale, v_scale,
                          page_table, seq_lens, *, page_size: int):
    """Plain PyTorch version of the kernel; same arguments and result."""
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    group, maxp = h // hkv, page_table.shape[1]
    phys = page_table.long().clamp_min(0)                   # [B, MAXP]
    k = (k_pages[phys].float() * k_scale[phys][:, :, None, :, None]
         ).reshape(b, maxp * page_size, hkv, d)
    v = (v_pages[phys].float() * v_scale[phys][:, :, None, :, None]
         ).reshape(b, maxp * page_size, hkv, d)
    qs = (q.float() * (1.0 / math.sqrt(d))).reshape(b, hkv, group, d)
    s = torch.einsum("bkgd,bskd->bkgs", qs, k)
    valid = (torch.arange(maxp * page_size, dtype=torch.int64,
                          device=q.device)[None, :]
             < seq_lens.to(q.device).long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", p, v) / p.sum(
        -1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, d).to(q.dtype)


def refresh_paged_attention(q, k_pages, v_pages, k_scale, v_scale,
                            page_table, seq_lens, *, page_size: int):
    """q: [B, H, D] float32/bfloat16; *_pages: [P, T, Hkv, D] int8 with
    T == page_size; *_scale: [P, Hkv] float32; page_table: [B, MAXP]
    int32 (entries past a sequence's pages may be -1); seq_lens: [B]
    int32. Returns [B, H, D] of q's dtype. Every tensor contiguous and on
    q's device; H a multiple of Hkv; on the card D at most `MAX_D` and a
    multiple of 16. The valid entries of
    the table must name pages below P (they are not bounds-checked on
    the card)."""
    global LAUNCHES
    from repro_torch.kernels import _build
    fn = "refresh_paged_attention"
    _build.check_tensor(fn, "q", q, dtypes=tuple(_DTYPES), ndim=3)
    dev = q.device
    for name, x, dts, nd in (("k_pages", k_pages, (torch.int8,), 4),
                             ("v_pages", v_pages, (torch.int8,), 4),
                             ("k_scale", k_scale, (torch.float32,), 2),
                             ("v_scale", v_scale, (torch.float32,), 2),
                             ("page_table", page_table, (torch.int32,), 2),
                             ("seq_lens", seq_lens, (torch.int32,), 1)):
        _build.check_tensor(fn, name, x, dtypes=dts, ndim=nd, device=dev)
    b, h, d = q.shape
    p_total, t, hkv, dk = k_pages.shape
    if (tuple(v_pages.shape) != tuple(k_pages.shape) or dk != d
            or t != page_size or tuple(k_scale.shape) != (p_total, hkv)
            or tuple(v_scale.shape) != (p_total, hkv)
            or page_table.shape[0] != b or tuple(seq_lens.shape) != (b,)
            or h % hkv):
        raise ValueError(
            f"{fn}: shapes do not fit: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, scales "
            f"{tuple(k_scale.shape)}/{tuple(v_scale.shape)}, page_table "
            f"{tuple(page_table.shape)}, seq_lens {tuple(seq_lens.shape)}, "
            f"page_size {page_size}")
    if dev.type in ("cpu", "meta"):
        return paged_attention_torch(q, k_pages, v_pages, k_scale, v_scale,
                                     page_table, seq_lens,
                                     page_size=page_size)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    if d > MAX_D or d % 16:
        raise ValueError(f"{fn}: the kernel takes D <= {MAX_D}, a multiple "
                         f"of 16; got D={d}")
    out = torch.empty_like(q)
    if b * h * d == 0:
        return out
    maxp = page_table.shape[1]
    nsplit = max(1, -(-maxp // SPLIT_PAGES))
    ws = torch.empty(b * h * nsplit * (d + 2), dtype=torch.float32,
                     device=dev)
    with torch.cuda.device(dev):
        _build.launch(f"paged_attention_{_DTYPES[q.dtype]}_launch",
                      q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      k_scale.data_ptr(), v_scale.data_ptr(),
                      page_table.data_ptr(), seq_lens.data_ptr(),
                      out.data_ptr(), ws.data_ptr(), b, h, hkv, d, t, maxp,
                      SPLIT_PAGES, torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return out
