"""The benchmark's own weights for a Zamba2-shaped hybrid, made on the
card from the seed in one draw, and the program's parameter tree over the
same tensors.

`make(cfg, seed, device)` draws every weight of the model from one
`torch.randn` call with a `torch.Generator` on `device`, in float32 (the
configuration's type), and cuts it into a flat dict (`shapes`): a leaf a
tensor of each Mamba layer, shared block and hybrid application, none
stacked (a stacked leaf of 1.3e9 parameters would need several of its
size at once in AdamW's update, which the card does not hold beside the
step's state). Matrices are N(0, 0.02), the output projections N(0, 0.02 /
sqrt(2 * layers)); conv weights N(0, 0.5), conv biases N(0, 0.02); norm
scales and D 1 + N(0, 0.02); dt_bias the inverse softplus of a dt
log-uniform in [time_step_min, time_step_max] and A_log the log of an A
uniform in [1, 16], both from the draw's normals through the normal CDF
(Mamba2's initialisation). No weight is a no-op the reference could get
wrong unseen.

`program_params(flat)` arranges the same tensors as the program's hybrid
takes them; `flat_params` is its inverse.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.zamba2 import widths

#: leaves drawn as 1 + N(0, 0.02), by the last part of their name
ONES = ("final_ln", "ln", "D", "norm_w", "attn_ln", "mlp_ln")
#: output projections: N(0, 0.02 / sqrt(2 * layers))
OUTS = ("out_proj", "wo", "w_down", "linear")


def shapes(cfg: dict) -> dict:
    """Leaf name -> shape: ``embed``, ``final_ln``, then each Mamba
    layer's (``mamba.<i>.*``), each shared block's (``shared.<b>.*``) and
    each application's adapter (``adapter.<j>.*``) and ``linear.<j>``."""
    w = widths(cfg)
    d, f = w["d"], cfg["intermediate_size"]
    r, nq, dh = cfg["adapter_rank"], w["nq"], w["dh"]
    nkv = cfg["num_key_value_heads"]
    out = {"embed": (cfg["vocab_size"], d), "final_ln": (d,)}
    for i in range(cfg["num_hidden_layers"]):
        out.update({f"mamba.{i}.{k}": v for k, v in (
            ("ln", (d,)), ("in_proj", (d, w["di"] + w["conv"] + w["h"])),
            ("conv_w", (w["conv"], cfg["mamba_d_conv"])),
            ("conv_b", (w["conv"],)), ("dt_bias", (w["h"],)),
            ("A_log", (w["h"],)), ("D", (w["h"],)), ("norm_w", (w["di"],)),
            ("out_proj", (w["di"], d)))})
    for b in range(cfg["num_mem_blocks"]):
        out.update({f"shared.{b}.{k}": v for k, v in (
            ("attn_ln", (2 * d,)), ("wq", (2 * d, nq, dh)),
            ("wk", (2 * d, nkv, dh)), ("wv", (2 * d, nkv, dh)),
            ("wo", (nq, dh, d)), ("mlp_ln", (d,)), ("w_gate", (d, f)),
            ("w_up", (d, f)), ("w_down", (f, d)))})
    for j in range(len(cfg["hybrid_layer_ids"])):
        out.update({f"adapter.{j}.a": (d, r), f"adapter.{j}.b_gate": (r, f),
                    f"adapter.{j}.b_up": (r, f), f"linear.{j}": (d, d)})
    return out


def make(cfg: dict, seed: int, device) -> dict:
    shp = shapes(cfg)
    sizes = {k: math.prod(s) for k, s in shp.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device,
                       dtype=torch.float32)
    out_scale = 0.02 / math.sqrt(2 * cfg["num_hidden_layers"])
    lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
    leaves, off = {}, 0
    for k, s in shp.items():
        x = flat[off:off + sizes[k]].view(s)
        off += sizes[k]
        kind = k.split(".")[-1] if k.startswith(("mamba.", "shared.",
                                                  "adapter.")) \
            else k.split(".")[0]
        if kind in ONES:
            x.mul_(0.02).add_(1.0)
        elif kind in OUTS:
            x.mul_(out_scale)
        elif kind == "conv_w":
            x.mul_(0.5)
        elif kind == "dt_bias":             # inverse softplus of dt
            dt = torch.exp(lo + (hi - lo) * _uniform(x))
            x.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif kind == "A_log":
            x.copy_(torch.log(1.0 + 15.0 * _uniform(x)))
        else:
            x.mul_(0.02)
        leaves[k] = x
    return leaves


def _uniform(z):
    """Standard normals to uniforms on (0, 1) (the normal CDF)."""
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


#: the program's names of the flat dict's leaves, by group
_MAMBA = {"ln": "ln", "in_proj": "in_proj", "conv_w": "conv_w",
          "conv_b": "conv_b", "dt_bias": "dt_bias", "A_log": "A_log",
          "D": "Dres", "norm_w": "norm_w", "out_proj": "wo"}
_ATTN = {"attn_ln": "ln", "wq": "wq", "wk": "wk", "wv": "wv", "wo": "wo"}
_MLP = {"mlp_ln": "ln", "w_gate": "wg", "w_up": "wi", "w_down": "wd"}
_ADAPTER = {"a": "a", "b_gate": "bg", "b_up": "bi"}


def _count(flat: dict, prefix: str) -> int:
    return len({k.split(".")[1] for k in flat if k.startswith(prefix + ".")})


def program_params(flat: dict) -> dict:
    """The program's tree (`repro_torch.models.hybrid`, published layout:
    a list of layers, of blocks, of adapters and of `linear`s) over the
    same tensors."""
    def group(prefix, names, i):
        return {v: flat[f"{prefix}.{i}.{k}"] for k, v in names.items()}
    return {"embed": flat["embed"], "final_ln": flat["final_ln"],
            "mamba": [group("mamba", _MAMBA, i)
                      for i in range(_count(flat, "mamba"))],
            "shared": [{"attn": group("shared", _ATTN, b),
                        "mlp": group("shared", _MLP, b)}
                       for b in range(_count(flat, "shared"))],
            "adapters": [group("adapter", _ADAPTER, j)
                         for j in range(_count(flat, "adapter"))],
            "linear": [flat[f"linear.{j}"]
                       for j in range(_count(flat, "linear"))]}


def flat_params(tree: dict) -> dict:
    """The inverse of `program_params`."""
    out = {"embed": tree["embed"], "final_ln": tree["final_ln"]}
    for i, lp in enumerate(tree["mamba"]):
        out.update({f"mamba.{i}.{k}": lp[v] for k, v in _MAMBA.items()})
    for b, bp in enumerate(tree["shared"]):
        out.update({f"shared.{b}.{k}": bp["attn"][v]
                    for k, v in _ATTN.items()})
        out.update({f"shared.{b}.{k}": bp["mlp"][v]
                    for k, v in _MLP.items()})
    for j, ap in enumerate(tree["adapters"]):
        out.update({f"adapter.{j}.{k}": ap[v] for k, v in _ADAPTER.items()})
        out[f"linear.{j}"] = tree["linear"][j]
    return out
