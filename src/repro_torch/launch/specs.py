"""Input builders for every (arch x shape) dry-run cell, on `meta`.

The counterpart of the reference's `launch/specs.py`. Nothing here
allocates memory: params, AdamW state and decode state come from the
real constructors on `device="meta"` (the counterpart of
`jax.eval_shape`; the port's `init` draws from a CPU `torch.Generator`,
which draws nothing on `meta`), and inputs are `meta` tensors. The specs
are the reference's logical-axis trees (tuples, one axis name or None a
dimension); `to_shardings` maps them onto a `DeviceMesh`
(`launch/mesh.py`), as the reference's maps them onto a TPU mesh.
"""
from __future__ import annotations

import torch

from repro_torch.common.config import ArchConfig, ShapeConfig
from repro_torch.common.treeutil import flatten_up_to, tree_flatten
from repro_torch.models.api import get_model
from repro_torch.models.dims import Dims
from repro_torch.optim import OptConfig, init_opt
from repro_torch.parallel.sharding import named_sharding_on

META = torch.device("meta")


def meta_tensor(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def opt_config_for(cfg: ArchConfig) -> OptConfig:
    # 400B config: bf16 first moment + factored second moment, as the
    # reference sizes it for its TPU pod
    if "llama4" in cfg.name:
        return OptConfig(moment_dtype="bfloat16", factored_v=True)
    return OptConfig()


def accum_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Microbatch count for train cells, the reference's: 4 for
    qwen2-vl-72b and zamba2-7b (activation memory), else 1."""
    if shape.kind != "train":
        return 1
    if cfg.name in ("qwen2-vl-72b", "zamba2-7b"):
        return 4
    return 1


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, *,
                with_labels: bool) -> dict:
    """Input batch as `meta` tensors ('train' includes labels), with the
    reference's shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    out = {}
    if cfg.family == "encdec":
        out["enc_embeds"] = meta_tensor((b, s, cfg.d_model), torch.bfloat16)
        out["tokens"] = meta_tensor((b, s) if with_labels else (b, 1),
                                    torch.int32)
    elif cfg.frontend == "embed":
        out["embeds"] = meta_tensor((b, s, cfg.d_model), torch.bfloat16)
        if cfg.attention is not None and cfg.attention.mrope:
            out["positions"] = meta_tensor((3, b, s), torch.int32)
    else:
        out["tokens"] = meta_tensor((b, s), torch.int32)
    if with_labels:
        out["labels"] = meta_tensor((b, s), torch.int32)
    return out


def batch_spec_axes(cfg: ArchConfig, batch: dict) -> dict:
    """Logical axes per batch entry (rank-matched)."""
    axes = {}
    for k, v in batch.items():
        if k == "positions":
            axes[k] = (None, "batch", None)
        elif v.ndim == 3:
            axes[k] = ("batch", None, None)
        else:
            axes[k] = ("batch",) + (None,) * (v.ndim - 1)
    return axes


def spec_leaves(specs) -> list:
    """The axis tuples of a spec tree in JAX's flatten order (dict keys
    sorted; a tuple is a leaf, None an empty subtree)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [] if specs is None else [tuple(specs)]


def _v_specs(pspecs, params, v):
    """The second moment's specs: the param's, or for a factored entry
    {"row", "col"} the param's with the last / second-to-last axis cut."""
    entries = []
    for s, e in zip(spec_leaves(pspecs),
                    flatten_up_to(tree_flatten(params)[1], v)):
        if isinstance(e, dict):
            entries.append({"row": s[:-1], "col": s[:-2] + s[-1:]})
        else:
            entries.append(s)
    it = iter(entries)

    def rebuild(node):                   # leaves taken in JAX's order
        if isinstance(node, dict):
            filled = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        return next(it)

    return rebuild(pspecs)


def state_shapes_and_specs(cfg: ArchConfig, dims: Dims, kind: str,
                           shape: ShapeConfig, *, opt_cfg: OptConfig = None):
    """Returns (tree of `meta` tensors, tree of logical-axis tuples) for
    the non-batch argument of the step function: {"params", "opt"} for
    train, the params for prefill, {"params", "state"} for decode. The
    train state's optimizer is `opt_cfg`, by default the arch's
    (`opt_config_for`)."""
    mod = get_model(cfg)

    def params():
        return mod.init(torch.Generator(), cfg, dims, META)

    if kind == "train":
        p = params()
        opt = init_opt(p, opt_cfg or opt_config_for(cfg))
        pspecs = mod.param_specs(cfg, dims)
        specs = {"params": pspecs,
                 "opt": {"m": pspecs, "v": _v_specs(pspecs, p, opt["v"]),
                         "step": ()}}
        return {"params": p, "opt": opt}, specs
    if kind == "prefill":
        return params(), mod.param_specs(cfg, dims)
    if kind == "decode":
        state = mod.init_decode_state(cfg, dims, shape.global_batch,
                                      shape.seq_len, device=META)
        return ({"params": params(), "state": state},
                {"params": mod.param_specs(cfg, dims),
                 "state": mod.decode_state_specs(cfg, dims)})
    raise ValueError(kind)


def to_shardings(mesh, logical_tree):
    """Logical-axis tuples -> `NamedSharding`s on `mesh` (None-safe): the
    reference's tree with a (mesh, placements) leaf where it has a
    `jax.sharding.NamedSharding`. Leaves are resolved in the port's
    `tree_flatten` order (JAX's sorted keys); the tree keeps its keys'
    order."""
    if isinstance(logical_tree, dict):
        done = {k: to_shardings(mesh, logical_tree[k])
                for k in sorted(logical_tree)}
        return {k: done[k] for k in logical_tree}
    if logical_tree is None:
        return None
    return named_sharding_on(mesh, tuple(logical_tree))
