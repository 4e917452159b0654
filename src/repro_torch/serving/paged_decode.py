"""Decode forward pass over the paged quantized KV cache (reference read
path), mirroring `repro/serving/paged_decode.py`.

The model's own decode_step uses a dense cache; the serving engine instead
reads K/V through PagedKVCache (int8 pages + bf16 staging) with
`gather_seq`: compressed pages dequantized, staged pages cast, then one
softmax over the sequence. That is the reference's arithmetic, and this
port keeps it: kernel C attends over int8 pages only, so it does not sit
under this read path. Linear layers and the MLP run on the params' device.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.common.treeutil import tree_map
from repro_torch.kvcache import PagedKVCache
from repro_torch.models import layers as L
from repro_torch.models.dims import Dims

#: Forward-call counters, keyed by entry point. The whole point of chunked
#: prefill is fewer host-side forward invocations per prompt token; tests
#: and benches read (and may zero) these to pin that ratio.
FORWARD_CALLS = {"decode": 0, "prefill": 0}


def _attend_one(q, k, v):
    """q [H,Dh]; k/v [S,Hkv,Dh] -> [H,Dh] (GQA expand by repeat)."""
    hq, dh = q.shape
    s, hkv, _ = k.shape
    group = hq // hkv
    kx = k.repeat_interleave(group, dim=1) if group > 1 else k
    vx = v.repeat_interleave(group, dim=1) if group > 1 else v
    scores = torch.einsum("hd,shd->hs", q.float(), kx.float()) / math.sqrt(dh)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("hs,shd->hd", p, vx.float())


def _rope_at(att, pos: int, device):
    """sin/cos [1, 1, Dh/2] at one position."""
    pv = torch.full((1, 1), pos, dtype=torch.int32, device=device)
    return L.rope_angles(pv, att.head_dim, att.rope_theta)


def _qkv(ap, x):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, ap["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, ap["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, ap["wv"].to(dt))
    if "bq" in ap:
        q = q + ap["bq"].to(dt)
        k = k + ap["bk"].to(dt)
        v = v + ap["bv"].to(dt)
    return q, k, v


def paged_decode_forward(params, cfg, dims: Dims, cache: PagedKVCache,
                         sids: Sequence[int], tokens):
    """One decode round for the active sequences.

    tokens: [B] next input token per active sequence (a tensor on the
    params' device). Returns (logits [B, V], k_new [L, B, H_kv, Dh],
    v_new [L, B, H_kv, Dh]) — the caller appends k/v_new into the cache
    afterwards.
    """
    FORWARD_CALLS["decode"] += 1
    att = cfg.attention
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    h = params["embed"][tokens[:, None]].to(dims.compute_dtype)
    k_news, v_news = [], []
    for li in range(cfg.n_layers):
        lp = tree_map(lambda x: x[li], params["layers"])
        ap = lp["attn"]
        x = L.rmsnorm(h, ap["ln"], cfg.norm_eps)
        dt = x.dtype
        q, k, v = _qkv(ap, x)
        outs = []
        for bi, sid in enumerate(sids):
            sin, cos = _rope_at(att, int(cache.seq_len[sid]), dev)
            qb = L.apply_rope(q[bi:bi + 1], sin, cos)[0, 0]
            kb = L.apply_rope(k[bi:bi + 1], sin, cos)[0, 0]
            vb = v[bi, 0]
            past_k, past_v = cache.gather_seq(sid, li, dims.compute_dtype)
            k_all = torch.cat([past_k, kb[None]], dim=0)
            v_all = torch.cat([past_v, vb[None]], dim=0)
            outs.append(_attend_one(qb, k_all, v_all))
        out = torch.stack(outs).to(dt)[:, None]                # [B,1,H,Dh]
        y = torch.einsum("bshk,hkd->bsd", out, ap["wo"].to(dt))
        h = h + y
        # mlp
        mp = lp["mlp"]
        x2 = L.rmsnorm(h, mp["ln"], cfg.norm_eps)
        h = h + L.gated_mlp(x2, mp["wi"], mp["wg"], mp["wd"])
        # rope'd K is what lives in the cache
        sinb, cosb = [], []
        for sid in sids:
            s_, c_ = _rope_at(att, int(cache.seq_len[sid]), dev)
            sinb.append(s_[0])
            cosb.append(c_[0])
        k_rope = L.apply_rope(k, torch.stack(sinb), torch.stack(cosb))
        k_news.append(k_rope[:, 0])
        v_news.append(v[:, 0])
    hf = L.rmsnorm(h, params["final_ln"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = torch.einsum("bd,dv->bv", hf[:, 0], head.to(hf.dtype))
    vmask = torch.arange(head.shape[-1], device=dev) < cfg.vocab_size
    logits = torch.where(vmask[None, :], logits.float(), -torch.inf)
    return logits, torch.stack(k_news), torch.stack(v_news)


def paged_prefill_forward(params, cfg, dims: Dims, cache: PagedKVCache,
                          sids: Sequence[int], chunks: Sequence[Sequence[int]]):
    """One chunked-prefill round: several prompt tokens per sequence, for
    several sequences, in ONE forward call.

    chunks[bi] is the next slice of sequence sids[bi]'s prompt (lengths may
    differ; shorter chunks are padded internally and the pad positions are
    never returned). The cache is NOT written here — the caller appends the
    returned K/V in order afterwards, so it can handle allocation failure
    (forced compression / eviction) itself.

    Bit-identical in semantics to feeding the same tokens one at a time
    through `paged_decode_forward` + `cache.append`: linear layers and the
    MLP run batched over the whole [B, T] chunk, while attention replays
    the sequential semantics exactly — a chunk token attends to earlier
    chunk tokens through the cache's storage dtype (as if they had already
    been appended) and to itself at full precision. Prompt logits are
    discarded by definition, so no lm_head work is done.

    Returns (k_new [L, B, Tmax, H_kv, Dh], v_new [L, B, Tmax, H_kv, Dh]);
    entries past len(chunks[bi]) are padding.
    """
    FORWARD_CALLS["prefill"] += 1
    att = cfg.attention
    bsz = len(sids)
    lens = [len(c) for c in chunks]
    assert bsz and all(lens), "every sequence needs a non-empty chunk"
    tmax = max(lens)
    toks = np.zeros((bsz, tmax), np.int64)
    for bi, c in enumerate(chunks):
        toks[bi, :len(c)] = c
    start = [int(cache.seq_len[sid]) for sid in sids]
    cdtype = cache.cfg.dtype
    dev = params["embed"].device
    h = params["embed"][torch.from_numpy(toks).to(dev)].to(
        dims.compute_dtype)                                  # [B, T, D]
    k_news, v_news = [], []
    for li in range(cfg.n_layers):
        lp = tree_map(lambda x: x[li], params["layers"])
        ap = lp["attn"]
        x = L.rmsnorm(h, ap["ln"], cfg.norm_eps)
        dt = x.dtype
        q, k, v = _qkv(ap, x)
        outs, k_layer, v_layer = [], [], []
        for bi, sid in enumerate(sids):
            past_k, past_v = cache.gather_seq(sid, li, dims.compute_dtype)
            kb_f, vb_f, ob = [], [], []
            for t in range(lens[bi]):
                sin, cos = _rope_at(att, start[bi] + t, dev)
                qb = L.apply_rope(q[bi:bi + 1, t:t + 1], sin, cos)[0, 0]
                kb = L.apply_rope(k[bi:bi + 1, t:t + 1], sin, cos)[0, 0]
                vb = v[bi, t]
                if t:
                    # earlier chunk tokens are seen through the cache's
                    # storage dtype, exactly as if already appended
                    k_prev = torch.stack(kb_f).to(cdtype).to(
                        dims.compute_dtype)
                    v_prev = torch.stack(vb_f).to(cdtype).to(
                        dims.compute_dtype)
                    k_all = torch.cat([past_k, k_prev, kb[None]], 0)
                    v_all = torch.cat([past_v, v_prev, vb[None]], 0)
                else:
                    k_all = torch.cat([past_k, kb[None]], 0)
                    v_all = torch.cat([past_v, vb[None]], 0)
                ob.append(_attend_one(qb, k_all, v_all))
                kb_f.append(kb)
                vb_f.append(vb)
            pad = tmax - lens[bi]
            outs.append(_pad_rows(torch.stack(ob), pad))
            k_layer.append(_pad_rows(torch.stack(kb_f), pad))
            v_layer.append(_pad_rows(torch.stack(vb_f), pad))
        out = torch.stack(outs).to(dt)                       # [B, T, H, Dh]
        y = torch.einsum("bshk,hkd->bsd", out, ap["wo"].to(dt))
        h = h + y
        mp = lp["mlp"]
        x2 = L.rmsnorm(h, mp["ln"], cfg.norm_eps)
        h = h + L.gated_mlp(x2, mp["wi"], mp["wg"], mp["wd"])
        k_news.append(torch.stack(k_layer))
        v_news.append(torch.stack(v_layer))
    return torch.stack(k_news), torch.stack(v_news)


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x [T, ...] with `pad` zero rows appended."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
