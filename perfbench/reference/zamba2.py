"""Plain PyTorch Zamba2 (the layer equations of `transformers`'
`models/zamba2/modeling_zamba2.py`; sizes from the configuration file):
the reference the hybrid training cells are held against. It imports
nothing of the program and no kernel.

The architecture as published: a token embedding; `num_hidden_layers`
layers, each a Mamba2 decoder layer, where the layers of
`hybrid_layer_ids` first run one of `num_mem_blocks` shared transformer
blocks in turn (block j mod `num_mem_blocks` at the j-th hybrid layer).
A shared block takes concat(h, embedding): RMSNorm, attention (q, k, v
without bias, rotate-half rotary embedding over the whole head at
`rope_theta`, causal softmax with the scores scaled by
(head_dim / 2)^-0.5, an output projection), RMSNorm, and a gelu-gated MLP
whose gate and up projections carry the application's own low-rank
adapter (`adapter_rank`); it has no residual. The hybrid layer's own
`linear` maps its output, which is added to the Mamba layer's input while
the layer's residual stays h. A Mamba2 layer: RMSNorm, one input
projection to (z, x, B, C, dt), a causal depthwise conv of
`mamba_d_conv` with a bias over (x, B, C) and silu, dt = softplus(dt +
dt_bias) clamped below at `time_step_min`, the SSD with B and C in
`mamba_ngroups` groups and the D residual, the gated RMSNorm taken per
group, an output projection. A final RMSNorm and the head tied to the
embedding.

The SSD is computed as the file's plain path computes it: in chunks of
`chunk_size` (256), with the within-chunk decay from `segment_sum` (the
exponent masked to -inf above the diagonal before the exp) and the
carried state across chunks. Everything is float32; `run.py` switches
TF32 off, and the control passes through `qwen2.matmul_precision`.

The weights are the benchmark's own (`traffic/weights_hybrid.py`), a
flat dict with a leaf a tensor of each layer, block and application
(``mamba.<i>.<name>``, ``shared.<b>.<name>``, ``adapter.<j>.<name>``,
``linear.<j>``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.qwen2 import rmsnorm, rope


def widths(cfg: dict) -> dict:
    """The derived sizes: d, inner width, SSD heads and head width, state
    and groups, attention heads and head width, conv channels."""
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    g, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    return {"d": d, "di": di, "h": cfg["n_mamba_heads"],
            "p": cfg["mamba_headdim"], "n": n, "g": g,
            "nq": cfg["num_attention_heads"],
            "dh": cfg["attention_head_dim"], "conv": di + 2 * g * n}


def segment_sum(a):
    """a [..., L] -> [..., L, L]: element (i, j) the sum of a over
    (j, i] for j <= i, -inf above the diagonal (the file's
    `segment_sum`: a cumulative sum of the masked, expanded input)."""
    L = a.shape[-1]
    x = a[..., None].expand(*a.shape, L)
    low = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device), -1)
    x = torch.cumsum(x.masked_fill(~low, 0), dim=-2)
    keep = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, -torch.inf)


def ssd(x, dt, A, B, C, chunk: int):
    """x [T, H, P], dt [T, H], A [H], B/C [T, G, N] -> y [T, H, P] (no D
    residual): the chunked scan, T a multiple of the chunk or shorter."""
    T, H, P = x.shape
    L = min(chunk, T)
    nc = T // L
    rep = H // B.shape[1]
    B = B.repeat_interleave(rep, dim=1).reshape(nc, L, H, -1)
    C = C.repeat_interleave(rep, dim=1).reshape(nc, L, H, -1)
    xd = (x * dt[..., None]).reshape(nc, L, H, P)
    a = (dt * A).reshape(nc, L, H).permute(2, 0, 1)          # [H, nc, L]
    acum = torch.cumsum(a, -1)
    decay = torch.exp(segment_sum(a))                        # [H, nc, L, L]
    cb = torch.einsum("clhn,cshn->hcls", C, B)
    y = torch.einsum("hcls,cshp->clhp", cb * decay, xd)
    to_end = torch.exp(acum[..., -1:] - acum)                # [H, nc, L]
    states = torch.einsum("clhn,hcl,clhp->chpn", B, to_end, xd)
    h = torch.zeros_like(states[0])
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * torch.exp(acum[:, c, -1])[:, None, None] + states[c]
    y = y + torch.einsum("clhn,chpn,hcl->clhp", C, torch.stack(prev),
                         torch.exp(acum))
    return y.reshape(T, H, P)


def mamba(lp, h, t, cfg):
    """One Mamba2 decoder layer over h [T, D]; `t` the shared block's
    output added to its input (None elsewhere)."""
    w = widths(cfg)
    T = h.shape[0]
    x = rmsnorm(h if t is None else h + t, lp["ln"], cfg["rms_norm_eps"])
    z, xbc, dt = torch.split(x @ lp["in_proj"],
                             [w["di"], w["conv"], w["h"]], -1)
    k = cfg["mamba_d_conv"]
    xbc = F.silu(F.conv1d(xbc.T[None], lp["conv_w"][:, None, :],
                          lp["conv_b"], padding=k - 1,
                          groups=w["conv"])[0, :, :T].T)
    xs, b, c = torch.split(xbc, [w["di"], w["g"] * w["n"],
                                 w["g"] * w["n"]], -1)
    dt = torch.clamp(F.softplus(dt + lp["dt_bias"]), cfg["time_step_min"])
    xs = xs.reshape(T, w["h"], w["p"])
    y = ssd(xs, dt, -torch.exp(lp["A_log"]),
            b.reshape(T, w["g"], w["n"]), c.reshape(T, w["g"], w["n"]),
            cfg["chunk_size"]) + lp["D"][:, None] * xs
    y = y.reshape(T, w["di"]) * F.silu(z)
    yg = y.reshape(T, w["g"], -1)
    yg = yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True)
                          + cfg["rms_norm_eps"])
    return h + (yg.reshape(T, w["di"]) * lp["norm_w"]) @ lp["out_proj"]


def shared(bp, ap, lin, h, emb, pos, cfg):
    """One application of a shared block and the hybrid layer's `linear`:
    [T, D] -> [T, D]."""
    eps = cfg["rms_norm_eps"]
    x = rmsnorm(torch.cat([h, emb], -1), bp["attn_ln"], eps)
    q, k, v = (torch.einsum("td,dhk->thk", x, bp[n])
               for n in ("wq", "wk", "wv"))
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    s = torch.einsum("thd,shd->hts", q, k) * (q.shape[-1] / 2) ** -0.5
    T = s.shape[-1]
    mask = torch.ones(T, T, dtype=torch.bool, device=s.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), -1)
    y = torch.einsum("thk,hkd->td", torch.einsum("hts,shd->thd", p, v),
                     bp["wo"])
    y = rmsnorm(y, bp["mlp_ln"], eps)
    a = y @ ap["a"]
    gate = y @ bp["w_gate"] + a @ ap["b_gate"]
    up = y @ bp["w_up"] + a @ ap["b_up"]
    return ((F.gelu(gate) * up) @ bp["w_down"]) @ lin


def pick(flat: dict, prefix: str) -> dict:
    """The leaves named `prefix`.<name>, by name."""
    return {k[len(prefix) + 1:]: v for k, v in flat.items()
            if k.startswith(prefix + ".")}


def hidden(flat: dict, tokens, cfg, remat: bool):
    """The final normed hidden states [T, D] of one sequence; with
    `remat` each layer and each shared-block application is recomputed in
    the backward pass (plain `torch.utils.checkpoint`)."""
    from torch.utils.checkpoint import checkpoint

    def run(fn, *a):
        return checkpoint(fn, *a, use_reentrant=False) if remat else fn(*a)

    pos = torch.arange(tokens.shape[0], device=tokens.device)
    emb = flat["embed"][tokens]
    h = emb
    rank = {li: j for j, li in enumerate(cfg["hybrid_layer_ids"])}
    for li in range(cfg["num_hidden_layers"]):
        t = None
        if li in rank:
            j = rank[li]
            t = run(lambda h_, bp, ap, lin: shared(bp, ap, lin, h_, emb, pos,
                                                   cfg),
                    h, pick(flat, f"shared.{j % cfg['num_mem_blocks']}"),
                    pick(flat, f"adapter.{j}"), flat[f"linear.{j}"])
        h = run(lambda h_, t_, lp: mamba(lp, h_, t_, cfg), h, t,
                pick(flat, f"mamba.{li}"))
    return rmsnorm(h, flat["final_ln"], cfg["rms_norm_eps"])


def logits(flat: dict, tokens, cfg):
    """[T, V] logits of one sequence, tied head."""
    return hidden(flat, tokens, cfg, False) @ flat["embed"].T


def loss(flat: dict, tokens, labels, cfg, block_rows: int = 1024):
    """Mean next-token cross-entropy plus the z-loss (`z_loss` times the
    mean squared log-sum-exp) over one sequence's rows, each layer
    recomputed in backward and the head's logits taken in blocks of
    rows, so it fits."""
    h = hidden(flat, tokens, cfg, True)
    tot = zl = 0.0
    for i in range(0, h.shape[0], block_rows):
        lg = h[i:i + block_rows] @ flat["embed"].T
        lse = torch.logsumexp(lg, -1)
        ll = lg.gather(-1, labels[i:i + block_rows, None])[:, 0]
        tot = tot + (lse - ll).sum()
        zl = zl + (lse * lse).sum()
    n = h.shape[0]
    return tot / n + cfg["z_loss"] * zl / n

