"""Encoder-decoder family (SeamlessM4T backbone), mirroring
`repro/models/encdec.py`: a bidirectional encoder over frontend-stub frame
embeddings and a causal decoder with cross-attention.

The reference's scans over the stacked layers are Python loops here, its
per-layer `jax.checkpoint` in train mode `transformer.remat`. On CUDA
tensors every attention of `encode`, `train_loss` and `prefill` is kernel
E through `layers.chunked_attention` (differentiable; in train mode it
runs again in the backward's recompute): the encoder's self-attention
and the cross-attention non-causal at any frame count, the decoder's
self-attention causal. Decode is plain torch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.treeutil import tree_index, tree_unbind
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import loss as LS
from repro_torch.models.dims import Dims
from repro_torch.models.transformer import _stack, remat
from repro_torch.parallel.sharding import place, shd


def init(gen: torch.Generator, cfg, dims: Dims, device="cuda"):
    """Random params drawn from `gen`, which lives on `device` (the card
    unless the caller asks for the CPU)."""
    out_scale = 0.02 / math.sqrt(2 * (cfg.n_layers + cfg.n_encoder_layers))

    def attn():
        return B.init_attn(gen, dims, device, out_scale=out_scale)

    def mlp():
        return B.init_mlp(gen, cfg.d_model, cfg.d_ff, dims, device,
                          out_scale)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dims.param_dtype,
                          device=device)

    return {
        "dec_embed": B._norm(gen, (dims.vocab, cfg.d_model),
                             dims.param_dtype, device),
        "enc_layers": _stack([{"attn": attn(), "mlp": mlp()}
                              for _ in range(cfg.n_encoder_layers)]),
        "dec_layers": _stack([{"self": attn(), "cross": attn(), "mlp": mlp()}
                              for _ in range(cfg.n_layers)]),
        "enc_final_ln": ones(),
        "final_ln": ones(),
        "lm_head": B._norm(gen, (cfg.d_model, dims.vocab), dims.param_dtype,
                           device),
    }


def param_specs(cfg, dims: Dims) -> dict:
    return {
        "dec_embed": ("vocab", "fsdp"),
        "enc_layers": B.stack_specs({"attn": B.attn_specs(dims),
                                     "mlp": B.mlp_specs()}),
        "dec_layers": B.stack_specs({"self": B.attn_specs(dims),
                                     "cross": B.attn_specs(dims),
                                     "mlp": B.mlp_specs()}),
        "enc_final_ln": (None,),
        "final_ln": (None,),
        "lm_head": (None, "vocab"),
    }


def _rope(cfg, bsz, seq, device):
    att = cfg.attention
    pos = torch.arange(seq, device=device)[None, :].expand(bsz, seq)
    return L.rope_angles(pos, att.head_dim, att.rope_theta)


def encode(params, cfg, dims: Dims, enc_embeds, mode="train"):
    """Frame embeddings [B,T,D] -> encoder memory [B,T,D]."""
    h = shd(enc_embeds.to(dims.compute_dtype), "batch", "seq", None)
    sin, cos = _rope(cfg, h.shape[0], h.shape[1], h.device)

    def body(h, lp):
        h, _ = B.apply_attn(lp["attn"], h, dims, sin=sin, cos=cos,
                            causal=False, mode="forward")
        return B.apply_mlp(lp["mlp"], h, dims)

    for lp in tree_unbind(params["enc_layers"], cfg.n_encoder_layers):
        h = remat(body, mode, h, lp)
    return L.rmsnorm(h, params["enc_final_ln"], cfg.norm_eps)


def _decode_stack(params, cfg, dims: Dims, tokens, enc_h, mode):
    h = L.embed_lookup(params["dec_embed"], tokens).to(dims.compute_dtype)
    h = shd(h, "batch", "seq", None)
    sin, cos = _rope(cfg, h.shape[0], h.shape[1], h.device)
    collect = mode == "prefill"
    ys = {"k": [], "v": [], "ck": [], "cv": []}

    def body(h, lp, enc_h):
        h, kv = B.apply_attn(lp["self"], h, dims, sin=sin, cos=cos,
                             causal=True, mode=mode)
        ckv = B.cross_kv(lp["cross"], enc_h, dims)
        h = B.apply_cross_attn(lp["cross"], h, dims, kv=ckv)
        return B.apply_mlp(lp["mlp"], h, dims), kv, ckv

    for lp in tree_unbind(params["dec_layers"], cfg.n_layers):
        h, kv, ckv = remat(body, mode, h, lp, enc_h)
        if collect:
            for key, x in zip(("k", "v", "ck", "cv"), kv + ckv):
                ys[key].append(x.to(dims.compute_dtype))
    h = L.rmsnorm(h, params["final_ln"], cfg.norm_eps)
    return h, ({k: torch.stack(x) for k, x in ys.items()} if collect
               else None)


def train_loss(params, batch, cfg, dims: Dims):
    """(loss, metrics): differentiable in the params."""
    enc_h = encode(params, cfg, dims, batch["enc_embeds"], mode="train")
    h, _ = _decode_stack(params, cfg, dims, batch["tokens"], enc_h, "train")
    return LS.lm_loss(h, params["lm_head"], batch["labels"],
                      logical_vocab=cfg.vocab_size)


def prefill(params, batch, cfg, dims: Dims):
    """Encode + decoder prefix (a single BOS of 0 by default); returns
    logits [B,V] and the decode state {"k", "v"} (self-attention cache of
    the prefix) and {"ck", "cv"} (cross K/V, fixed for the generation),
    each [L,B,S,Hkv,dh]."""
    enc_h = encode(params, cfg, dims, batch["enc_embeds"], mode="prefill")
    bos = batch.get("tokens")
    if bos is None:
        bos = torch.zeros((enc_h.shape[0], 1), dtype=torch.int32,
                          device=enc_h.device)
    h, state = _decode_stack(params, cfg, dims, bos, enc_h, "prefill")
    logits = LS.logits_for(L.last_position(h), params["lm_head"], cfg.vocab_size)
    return logits, state


def init_decode_state(cfg, dims: Dims, batch: int, kv_len: int,
                      enc_len: int = None, device="cuda"):
    att = cfg.attention
    enc_len = enc_len or kv_len

    def z(s):
        return place(torch.zeros((cfg.n_layers, batch, s, dims.n_kv,
                                  att.head_dim), dtype=dims.compute_dtype,
                                 device=device),
                     None, "batch", "pages", None, None)

    return {"k": z(kv_len), "v": z(kv_len), "ck": z(enc_len),
            "cv": z(enc_len)}


def decode_state_specs(cfg, dims: Dims) -> dict:
    kv = (None, "batch", "pages", None, None)
    return {"k": kv, "v": kv, "ck": kv, "cv": kv}


def decode_step(params, state, cfg, dims: Dims, *, token=None, embed=None,
                pos=None):
    """One-token decode. token [B]; pos: int, the current length.
    Returns (logits [B,V], new state)."""
    h = L.embed_lookup(params["dec_embed"],
                       token[:, None]).to(dims.compute_dtype)
    bsz = h.shape[0]
    att = cfg.attention
    posv = torch.full((bsz, 1), int(pos), dtype=torch.int32, device=h.device)
    sin, cos = L.rope_angles(posv, att.head_dim, att.rope_theta)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        lp = tree_index(params["dec_layers"], li)
        h, (kc, vc) = B.apply_attn(lp["self"], h, dims, sin=sin, cos=cos,
                                   causal=True, mode="decode",
                                   cache=(state["k"][li], state["v"][li]),
                                   pos=int(pos))
        h = B.apply_cross_attn(lp["cross"], h, dims,
                               kv=(state["ck"][li], state["cv"][li]),
                               mode="decode")
        h = B.apply_mlp(lp["mlp"], h, dims, seq_shard=False)
        ks.append(kc)
        vs.append(vc)
    h = L.rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = LS.logits_for(h[:, 0], params["lm_head"], cfg.vocab_size)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "ck": state["ck"], "cv": state["cv"]}
