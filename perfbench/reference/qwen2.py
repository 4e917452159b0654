"""Plain PyTorch Qwen2 (arXiv:2407.10671): the reference the training
cells are held against. It imports nothing of the program.

The architecture as published: token embedding, `n_layers` pre-norm
blocks of grouped-query attention (q, k, v projections with biases,
split-half rotary embedding at `rope_theta`, causal softmax attention,
an output projection) and a SwiGLU MLP (up * silu(gate), down), RMSNorm
with a learned scale, a final RMSNorm and the output head tied to the
embedding. Everything is float32; `run.py` switches TF32 off, and a
caller passing ``tf32=True`` gets the control, the same arithmetic with
TF32 matrix products.

The weights are the benchmark's own (`traffic/weights.py`), handed to
the program and to this module alike; their layout (``layers`` stacked
over the layer axis, ``wq`` as [d, heads, head_dim]) is the one the
benchmark makes, not one taken from the program.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on for the control, off for the reference; restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta: float):
    """x [T, H, Dh] at integer positions `pos` [T]: split-half rotation."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = pos.float()[:, None] * inv[None, :]
    s, c = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def layer(p: dict, li: int) -> dict:
    return {k: v[li] for k, v in p["layers"].items()}


def qkv(lp, x, pos, cfg):
    """x [T, D] -> q [T, Hq, Dh], k, v [T, Hkv, Dh], q and k rotated."""
    q = torch.einsum("td,dhk->thk", x, lp["wq"]) + lp["bq"]
    k = torch.einsum("td,dhk->thk", x, lp["wk"]) + lp["bk"]
    v = torch.einsum("td,dhk->thk", x, lp["wv"]) + lp["bv"]
    return (rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"]),
            v)


def mlp(lp, h, cfg):
    x = rmsnorm(h, lp["mlp_ln"], cfg["rms_norm_eps"])
    return (x @ lp["wi"]) * F.silu(x @ lp["wg"]) @ lp["wd"]


def expand(k, group: int):
    return k.repeat_interleave(group, dim=1)


# ---------------------------------------------------------------- training
def block(lp, h, pos, cfg):
    """One layer over a whole sequence h [T, D], causal."""
    x = rmsnorm(h, lp["attn_ln"], cfg["rms_norm_eps"])
    q, k, v = qkv(lp, x, pos, cfg)
    g = q.shape[1] // k.shape[1]
    k, v = expand(k, g), expand(v, g)
    s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(q.shape[-1])
    t = s.shape[-1]
    mask = torch.ones(t, t, dtype=torch.bool, device=s.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), -1)
    o = torch.einsum("hts,shd->thd", p, v)
    h = h + torch.einsum("thk,hkd->td", o, lp["wo"])
    return h + mlp(lp, h, cfg)


def loss(params: dict, tokens, labels, cfg, block_rows: int = 1024):
    """Mean next-token cross-entropy plus the z-loss (1e-4 * mean of the
    squared log-sum-exp), over one sequence's rows; each layer is
    recomputed in the backward pass (plain `torch.utils.checkpoint`) and
    the head's logits are taken in blocks of rows, so it fits."""
    from torch.utils.checkpoint import checkpoint
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    h = params["embed"][tokens]
    for li in range(cfg["num_hidden_layers"]):
        lp = layer(params, li)
        h = checkpoint(block, lp, h, pos, cfg, use_reentrant=False)
    h = rmsnorm(h, params["final_ln"], cfg["rms_norm_eps"])
    tot = zl = 0.0
    for i in range(0, h.shape[0], block_rows):
        logits = h[i:i + block_rows] @ params["embed"].T
        lse = torch.logsumexp(logits, -1)
        ll = logits.gather(-1, labels[i:i + block_rows, None])[:, 0]
        tot = tot + (lse - ll).sum()
        zl = zl + (lse * lse).sum()
    n = h.shape[0]
    return tot / n + cfg["z_loss"] * zl / n
