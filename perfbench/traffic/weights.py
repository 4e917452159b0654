"""The benchmark's own weights for a Qwen2-shaped model, made on the card
from the seed in one draw, and the program's parameter tree over the
same tensors.

`make(cfg, seed, device)` draws every matrix, bias and norm scale of the
model from one `torch.randn` call with a `torch.Generator` on `device`,
in float32 (the configuration's type), and cuts it into a flat dict:
``embed`` [V, D], ``final_ln`` [D] and ``layers`` (each leaf stacked
over the layer axis). Matrices are N(0, 0.02), the output projections
N(0, 0.02 / sqrt(2 * layers)); biases N(0, 0.02); norm scales 1 +
N(0, 0.02), so that none of them is a no-op the reference could get
wrong unseen.

`program_params(flat)` arranges the same tensors as the program's
transformer takes them (`{"embed", "final_ln", "layers": {"attn": {...},
"mlp": {...}}}`); the reference reads the flat dict.
"""
from __future__ import annotations

import math

import torch


def shapes(cfg: dict) -> dict:
    L, D, F = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["intermediate_size"])
    Hq, Hkv, Dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    return {
        "embed": (cfg["vocab_size"], D),
        "final_ln": (D,),
        "attn_ln": (L, D), "wq": (L, D, Hq, Dh), "wk": (L, D, Hkv, Dh),
        "wv": (L, D, Hkv, Dh), "wo": (L, Hq, Dh, D), "bq": (L, Hq, Dh),
        "bk": (L, Hkv, Dh), "bv": (L, Hkv, Dh),
        "mlp_ln": (L, D), "wi": (L, D, F), "wg": (L, D, F), "wd": (L, F, D),
    }


def make(cfg: dict, seed: int, device) -> dict:
    shp = shapes(cfg)
    sizes = {k: math.prod(s) for k, s in shp.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device,
                       dtype=torch.float32)
    out_scale = 0.02 / math.sqrt(2 * cfg["num_hidden_layers"])
    leaves, off = {}, 0
    for k, s in shp.items():
        x = flat[off:off + sizes[k]].view(s)
        off += sizes[k]
        if k in ("final_ln", "attn_ln", "mlp_ln"):
            x.mul_(0.02).add_(1.0)
        else:
            x.mul_(out_scale if k in ("wo", "wd") else 0.02)
        leaves[k] = x
    params = {"embed": leaves.pop("embed"),
              "final_ln": leaves.pop("final_ln"), "layers": leaves}
    return params


def program_params(p: dict) -> dict:
    ly = p["layers"]
    return {"embed": p["embed"], "final_ln": p["final_ln"],
            "layers": {"attn": {"ln": ly["attn_ln"], "wq": ly["wq"],
                                "wk": ly["wk"], "wv": ly["wv"],
                                "wo": ly["wo"], "bq": ly["bq"],
                                "bk": ly["bk"], "bv": ly["bv"]},
                       "mlp": {"ln": ly["mlp_ln"], "wi": ly["wi"],
                               "wg": ly["wg"], "wd": ly["wd"]}}}


def flat_params(tree: dict) -> dict:
    """The inverse of `program_params`: the program's tree as the flat
    dict the reference reads."""
    a, m = tree["layers"]["attn"], tree["layers"]["mlp"]
    return {"embed": tree["embed"], "final_ln": tree["final_ln"],
            "layers": {"attn_ln": a["ln"], "wq": a["wq"], "wk": a["wk"],
                       "wv": a["wv"], "wo": a["wo"], "bq": a["bq"],
                       "bk": a["bk"], "bv": a["bv"], "mlp_ln": m["ln"],
                       "wi": m["wi"], "wg": m["wg"], "wd": m["wd"]}}
