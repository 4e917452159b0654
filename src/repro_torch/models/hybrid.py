"""Zamba2-style hybrid, mirroring `repro/models/hybrid.py`: a Mamba2
backbone plus ONE shared-weight attention(+MLP) block applied every
`attn_every` layers. An arch with `hybrid_layers` takes the published
Zamba2 layout instead (`_published_*` below; `configs/zamba2_7b_instruct`
has its equations); everything else here is the layout above.

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
import torch.nn.functional as F

from repro_torch.common import trace
from repro_torch.common.treeutil import tree_index, tree_unbind
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import loss as LS
from repro_torch.models.dims import Dims
from repro_torch.models.transformer import _embed_in, _stack, remat
from repro_torch.parallel.sharding import place, shd


def _split(cfg):
    groups = cfg.n_layers // cfg.attn_every
    per = cfg.attn_every - 1
    tail = cfg.n_layers - groups * cfg.attn_every
    return groups, per, tail


def init(gen: torch.Generator, cfg, dims: Dims, device="cuda"):
    """Random params drawn from `gen`, which lives on `device` (the card
    unless the caller asks for the CPU)."""
    if cfg.hybrid_layers:
        return _published_init(gen, cfg, dims, device)
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


def param_specs(cfg, dims: Dims) -> dict:
    _train_only(cfg, "param_specs")
    groups, per, tail = _split(cfg)
    specs = {
        "embed": ("vocab", "fsdp"),
        "groups": B.stack_specs(B.mamba_specs(), 2),
        "shared": {"attn": B.attn_specs(dims), "mlp": B.mlp_specs()},
        "final_ln": (None,),
        "lm_head": (None, "vocab"),
    }
    if tail:
        specs["tail"] = B.stack_specs(B.mamba_specs())
    return specs


def _rope(cfg, bsz, seq, device):
    att = cfg.attention
    pos = torch.arange(seq, device=device)[None, :].expand(bsz, seq)
    return L.rope_angles(pos, att.head_dim, att.rope_theta)


def forward(params, cfg, dims: Dims, *, tokens=None, embeds=None,
            positions=None, mode: str = "train"):
    """Full-sequence forward. Returns (h_final, states_or_None): in
    prefill mode {"groups_mamba" [G, per, ...], "k"/"v" [G,B,S,Hkv,dh],
    "tail_mamba" [tail, ...] or None}."""
    if cfg.hybrid_layers:
        _train_only(cfg, f"forward in {mode} mode", mode == "train")
        return _published_forward(params, cfg, dims, tokens, embeds, mode)
    groups, per, tail = _split(cfg)
    h = _embed_in(params, dims, tokens, embeds)
    bsz, seq = h.shape[:2]
    h = shd(h, "batch", "seq", None)
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
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return LS.lm_loss(h, head, batch["labels"], logical_vocab=cfg.vocab_size)


def prefill(params, batch, cfg, dims: Dims):
    """Returns (last-token logits [B,V], decode state as `forward`'s)."""
    _train_only(cfg, "prefill")
    h, states = forward(params, cfg, dims, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"), mode="prefill")
    logits = LS.logits_for(L.last_position(h), params["lm_head"], cfg.vocab_size)
    states = dict(states)
    for key in ("k", "v"):
        states[key] = shd(states[key], None, "batch", "pages", None, None)
    return logits, states


def init_decode_state(cfg, dims: Dims, batch: int, kv_len: int,
                      device="cuda"):
    _train_only(cfg, "init_decode_state")
    groups, per, tail = _split(cfg)
    one = B.mamba_state_shapes(dims, batch, device)
    att = cfg.attention

    def stacked(*lead):
        return {k: torch.zeros(lead + tuple(z.shape), dtype=z.dtype,
                               device=device) for k, z in one.items()}

    shape = (groups, batch, kv_len, dims.n_kv, att.head_dim)
    def kv():
        return place(torch.zeros(shape, dtype=dims.compute_dtype,
                                 device=device),
                     None, "batch", "pages", None, None)

    return {"groups_mamba": stacked(groups, per), "k": kv(), "v": kv(),
            "tail_mamba": stacked(tail) if tail else None}


def decode_state_specs(cfg, dims: Dims) -> dict:
    _train_only(cfg, "decode_state_specs")
    groups, per, tail = _split(cfg)
    m1 = B.mamba_decode_state_specs()
    kv = (None, "batch", "pages", None, None)
    return {"groups_mamba": {k: ("stack",) + v for k, v in m1.items()},
            "k": kv, "v": kv, "tail_mamba": m1 if tail else None}


def decode_step(params, state, cfg, dims: Dims, *, token=None, embed=None,
                pos=None):
    """One-token decode. token [B] / embed [B,D]; pos: int, the current
    length. Returns (logits [B,V], new state)."""
    _train_only(cfg, "decode_step")
    groups, per, tail = _split(cfg)
    if embed is not None:
        h = embed[:, None, :].to(dims.compute_dtype)
    else:
        h = L.embed_lookup(params["embed"],
                           token[:, None]).to(dims.compute_dtype)
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
        h = B.apply_mlp(params["shared"]["mlp"], h, dims, seq_shard=False)
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


# ====================================================== the published layout
def _train_only(cfg, what: str, ok: bool = False) -> None:
    if cfg.hybrid_layers and not ok:
        raise NotImplementedError(f"{cfg.name}: {what} is not ported for "
                                  f"the published hybrid layout (train "
                                  f"only)")


def _published_init(gen: torch.Generator, cfg, dims: Dims, device):
    """``mamba`` (a list: each layer's grouped mixer), ``shared`` (a
    list of the `n_mem_blocks` blocks: attention over the concatenated
    [h, embedding] and the gated MLP), ``adapters`` and ``linear`` (lists,
    one an application), ``embed`` (also the tied head) and ``final_ln``.
    Nothing is stacked: AdamW's update of one stacked leaf of a full-width
    layer set would need several copies of it at once beside the step's
    state, and its vectors (norm scales, dt_bias, A_log, D, conv biases)
    are then not decayed, as `OptConfig` decays leaves of two or more
    axes."""
    d, dh, f = cfg.d_model, cfg.attention.head_dim, cfg.d_ff
    nq, r, apps = dims.n_q, cfg.adapter_rank, len(cfg.hybrid_layers)
    pdt = dims.param_dtype
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)

    def block():
        return {"attn": {"ln": torch.ones((2 * d,), dtype=pdt, device=device),
                         "wq": B._norm(gen, (2 * d, nq, dh), pdt, device),
                         "wk": B._norm(gen, (2 * d, dims.n_kv, dh), pdt,
                                       device),
                         "wv": B._norm(gen, (2 * d, dims.n_kv, dh), pdt,
                                       device),
                         "wo": B._norm(gen, (nq, dh, d), pdt, device,
                                       out_scale)},
                "mlp": {"ln": torch.ones((d,), dtype=pdt, device=device),
                        "wg": B._norm(gen, (d, f), pdt, device),
                        "wi": B._norm(gen, (d, f), pdt, device),
                        "wd": B._norm(gen, (f, d), pdt, device, out_scale)}}

    return {
        "embed": B._norm(gen, (dims.vocab, d), pdt, device),
        "mamba": [B.init_mamba_grouped(gen, dims, device, out_scale)
                  for _ in range(cfg.n_layers)],
        "shared": [block() for _ in range(cfg.n_mem_blocks)],
        "adapters": [{"a": B._norm(gen, (d, r), pdt, device),
                      "bg": B._norm(gen, (r, f), pdt, device),
                      "bi": B._norm(gen, (r, f), pdt, device)}
                     for _ in range(apps)],
        "linear": [B._norm(gen, (d, d), pdt, device, out_scale)
                   for _ in range(apps)],
        "final_ln": torch.ones((d,), dtype=pdt, device=device),
    }


def _shared_block(sp, ap, lin, h, emb, cfg, dims: Dims, sin, cos):
    """One application of a shared block and its `linear`, in the span
    ``hybrid.shared`` (CUDA events on the card): RMSNorm of concat(h,
    embedding), attention (kernel E on the card) with the scores scaled
    by (head_dim / 2)^-0.5 (q times sqrt(2): E scales by head_dim^-0.5),
    RMSNorm, the gelu-gated MLP with this application's adapter on
    gate/up, then `linear`. No residual: the Mamba layer adds the result
    to its input."""
    eps = cfg.norm_eps
    with trace.span("hybrid.shared", h.device):
        x = L.rmsnorm(torch.cat([h, emb], -1), sp["attn"]["ln"], eps)
        q, k, v = B._project_qkv(sp["attn"], x, dims, sin, cos, rope=True)
        q = q * math.sqrt(2.0)
        ke, ve = L._expand_kv(k, dims.q_group), L._expand_kv(v, dims.q_group)
        o = L.chunked_attention(q, ke, ve, causal=True)
        y = L.rmsnorm(L.eins("bshk,hkd->bsd", o, sp["attn"]["wo"]),
                      sp["mlp"]["ln"], eps)
        gate = L.eins("bsd,df->bsf", y, sp["mlp"]["wg"])
        up = L.eins("bsd,df->bsf", y, sp["mlp"]["wi"])
        if cfg.adapter_rank:
            a = L.eins("bsd,dr->bsr", y, ap["a"])
            gate = gate + L.eins("bsr,rf->bsf", a, ap["bg"])
            up = up + L.eins("bsr,rf->bsf", a, ap["bi"])
        y = L.eins("bsf,fd->bsd", F.gelu(gate.float()).to(up.dtype) * up,
                   sp["mlp"]["wd"])
        return L.eins("bsd,de->bse", y, lin)


def _published_forward(params, cfg, dims: Dims, tokens, embeds, mode: str):
    """(h_final, None). At a hybrid layer i, the shared block of i's rank
    among the hybrid layers (mod `n_mem_blocks`) runs first, with that
    rank's adapter and `linear`; then every layer's Mamba mixer takes
    h + that output, h its residual. Each shared-block application and
    each Mamba layer is rematerialized in backward."""
    emb = _embed_in(params, dims, tokens, embeds)
    bsz, seq = emb.shape[:2]
    sin, cos = _rope(cfg, bsz, seq, emb.device)
    rank = {li: j for j, li in enumerate(cfg.hybrid_layers)}

    def mamba_body(h, t, lp):
        return h + B.apply_mamba_grouped(lp, h if t is None else h + t, dims)

    def shared_body(h, sp, ap, lin):
        return _shared_block(sp, ap, lin, h, emb, cfg, dims, sin, cos)

    h = emb
    for li, lp in enumerate(params["mamba"]):
        t = None
        if li in rank:
            j = rank[li]
            t = remat(shared_body, mode, h,
                      params["shared"][j % cfg.n_mem_blocks],
                      params["adapters"][j], params["linear"][j])
        h = remat(mamba_body, mode, h, t, lp)
    return L.rmsnorm(h, params["final_ln"], cfg.norm_eps), None

