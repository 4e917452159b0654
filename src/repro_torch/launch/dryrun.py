"""Dry run: every (arch x shape) cell's step on `meta`, on one H100 and on
the reference's two production meshes, with its memory, op counts,
collectives and roofline a device, before any chip time is spent.

The counterpart of the reference's `launch/dryrun.py`, which lowers and
compiles each cell for a TPU mesh. Here the step runs eagerly on `meta`
tensors (shapes only, nothing computed or allocated) under
`parallel.op_analysis.analyze_ops`; the models take their plain route on
`meta`, as the reference's dry run lowers its models' plain path.

Meshes (``mesh`` of a record):
  h100x1      one card: `make_dims(tp=1)`, no context;
  pod16x16    (data=16, model=16) over 256 ranks, the single-pod rules;
  pod2x16x16  (pod=2, data=16, model=16) over 512 ranks, the multi-pod
              rules.
A production mesh is built in a fake world of its size in this process
(`launch.mesh.fake_world`: rank 0, collectives that move nothing), as
the reference's run does: `tp` = the model ways, ``batch`` disabled
where the global batch is under the data ways, the state and batch laid
out by `specs.to_shardings` as `meta` DTensors (a decode token over
``batch``), the step run under `sharding_context`. `analyze_ops` then
counts rank 0's local ops and DTensor's collectives.

Usage:
  python -m repro_torch.launch.dryrun                   # all three meshes
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --single-pod-only   # (16, 16)
  python -m repro_torch.launch.dryrun --multi-pod-only    # (2, 16, 16)
  python -m repro_torch.launch.dryrun --one-card-only     # h100x1

Per cell, writes results/dryrun_torch/<arch>__<shape>__<mesh>.json with
the reference's keys where their meaning holds, a device: ``devices``,
``memory`` (``argument_gb``, ``output_gb``; ``temp_gb`` and ``peak_gb``
null: `meta` allocates nothing, so the step's temporaries are not
known), ``ops`` (the reference's ``hlo``, with each collective kind's
``collective_links`` and the wire bytes by link), ``roofline``,
``model_flops_global``, ``useful_flop_ratio`` and ``roofline_fraction``
(of ``model_flops_global / devices``); and ``fits_one_card`` (a device's
arguments + outputs within the card's 80 GB). A decode cell runs one
step at the last position of a full `seq_len` cache.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.common.config import (SHAPE_SETS, applicable_shapes,
                                       get_arch, list_archs)
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.api import get_model
from repro_torch.models.dims import make_dims
from repro_torch.parallel.op_analysis import (HBM_BYTES, PEAK_FLOPS,
                                              analyze_ops)
from repro_torch.parallel.sharding import (LOGICAL_RULES_MULTI_POD,
                                           LOGICAL_RULES_SINGLE_POD,
                                           distribute, mesh_axis_size,
                                           sharding_context)
from repro_torch.train.step import make_train_step

ONE_CARD = "h100x1"
#: mesh name -> multi_pod of `make_production_mesh` (None: one card)
MESHES = {ONE_CARD: None, "pod16x16": False, "pod2x16x16": True}


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE) for train;
    2*N*D for prefill; 2*N_active per token * new tokens for decode."""
    n = cfg.active_param_count()
    d_tokens = shape.seq_len * shape.global_batch
    if shape.kind == "train":
        return 6.0 * n * d_tokens
    if shape.kind == "prefill":
        return 2.0 * n * d_tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def cell_step(cfg, dims, shape):
    """(fn, args) of one cell's step on `meta`: the train step, the
    prefill, or one decode step."""
    return cell_step_and_axes(cfg, dims, shape)[:2]


def cell_step_and_axes(cfg, dims, shape):
    """`cell_step`'s (fn, args) and the logical axes of the arguments
    (the reference's in_shardings)."""
    mod = get_model(cfg)
    state, specs = SP.state_shapes_and_specs(cfg, dims, shape.kind, shape)
    if shape.kind == "train":
        batch = SP.batch_specs(cfg, shape, with_labels=True)
        step = make_train_step(cfg, dims, SP.opt_config_for(cfg),
                               accum=SP.accum_for(cfg, shape),
                               device=SP.META)
        return step, (state, batch), (specs, SP.batch_spec_axes(cfg, batch))
    if shape.kind == "prefill":
        batch = SP.batch_specs(cfg, shape, with_labels=False)

        def pf(params, b):
            return mod.prefill(params, b, cfg, dims)
        return pf, (state, batch), (specs, SP.batch_spec_axes(cfg, batch))
    b = shape.global_batch
    if cfg.frontend == "embed" and cfg.family != "encdec":
        tok = {"embed": SP.meta_tensor((b, cfg.d_model), torch.bfloat16)}
        tok_axes = {"embed": ("batch", None)}
    else:
        tok = {"token": SP.meta_tensor((b,), torch.int32)}
        tok_axes = {"token": ("batch",)}

    def dec(sd, tk):
        return mod.decode_step(sd["params"], sd["state"], cfg, dims,
                               pos=shape.seq_len - 1, **tk)
    return dec, (state, tok), (specs, tok_axes)


@contextlib.contextmanager
def production_cell(cfg, shape, multi_pod: bool):
    """One cell's step on a production mesh, as the reference's `run_cell`
    lays it out: inside a fake world of the mesh's size and the cell's
    `sharding_context`, yields (fn, args, dims, devices), the arguments
    `meta` DTensors of their specs."""
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = (LOGICAL_RULES_MULTI_POD if multi_pod
                 else LOGICAL_RULES_SINGLE_POD)
        # batch=1 cells cannot shard the batch axis
        disabled = ({"batch"} if shape.global_batch
                    < mesh_axis_size(mesh, "data") else set())
        dims = make_dims(cfg, tp=mesh_axis_size(mesh, "model"))
        with sharding_context(mesh, rules, disabled):
            fn, args, axes = cell_step_and_axes(cfg, dims, shape)
            args = tuple(distribute(a, SP.to_shardings(mesh, ax))
                         for a, ax in zip(args, axes))
            yield fn, args, dims, mesh.size()


def _analyze(cfg, shape, multi_pod):
    """(ops, dims, devices) of one cell: on one card (`multi_pod` None),
    or on a production mesh."""
    if multi_pod is None:
        dims = make_dims(cfg, tp=1)
        fn, args = cell_step(cfg, dims, shape)
        return analyze_ops(fn, *args), dims, 1
    with production_cell(cfg, shape, multi_pod) as (fn, args, dims, n):
        return analyze_ops(fn, *args), dims, n


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             overwrite: bool = False) -> dict:
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(path) and not overwrite:
        with open(path) as f:
            return json.load(f)
    cfg = get_arch(arch)
    shape = SHAPE_SETS[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "ok": False}
    t0 = time.time()
    try:
        ops, dims, devices = _analyze(cfg, shape, MESHES[mesh_name])
        mf = model_flops(cfg, shape)
        roof = ops.roofline()
        arg_gb, out_gb = ops.argument_bytes / 1e9, ops.output_bytes / 1e9
        peak = PEAK_FLOPS[str(dims.compute_dtype).replace("torch.", "")]
        rec.update({
            "ok": True,
            "analyze_s": round(time.time() - t0, 1),
            "devices": devices,
            "memory": {
                "argument_gb": arg_gb,
                "output_gb": out_gb,
                "temp_gb": None,
                "alias_gb": 0.0,
                "peak_gb": None,
                "note": "meta tensors allocate nothing: the step's "
                        "temporaries, and so its peak, are not known; "
                        "nothing is donated",
            },
            "fits_one_card": (ops.argument_bytes + ops.output_bytes
                              <= HBM_BYTES),
            "ops": {
                "flops_per_dev": ops.flops,
                "dot_flops_per_dev": ops.dot_flops,
                "dot_flops_by_dtype": ops.dot_flops_by_dtype,
                "hbm_bytes_per_dev": ops.hbm_bytes,
                "wire_bytes_per_dev": ops.wire_bytes,
                "collective_counts": ops.collective_counts,
                "collective_wire_bytes": ops.collective_wire,
                "collective_links": ops.collective_links,
                "link_wire_bytes": ops.link_wire,
                "n_ops": ops.n_instructions,
            },
            "roofline": roof,
            "model_flops_global": mf,
            "useful_flop_ratio": (mf / devices / ops.flops if ops.flops
                                  else 0.0),
            "roofline_fraction": ((mf / devices / peak) / roof["bound_s"]
                                  if roof["bound_s"] > 0 else 0.0),
        })
    except Exception as e:  # recorded per cell; the run reports failures
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=12)
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec["ok"]:
        extra = (f"args={arg_gb:.2f}GB out={out_gb:.2f}GB "
                 f"fits={rec['fits_one_card']} "
                 f"dom={roof['dominant']} bound={roof['bound_s']:.4g}s "
                 f"roof%={100 * rec['roofline_fraction']:.1f} "
                 f"analyze={rec['analyze_s']}s")
    else:
        extra = rec["error"][:160]
    print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {cell_id} {extra}",
          flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--overwrite", action="store_true")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--one-card-only", action="store_true")
    only.add_argument("--single-pod-only", action="store_true")
    only.add_argument("--multi-pod-only", action="store_true")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list_archs()
    meshes = ([ONE_CARD] if args.one_card_only
              else ["pod16x16"] if args.single_pod_only
              else ["pod2x16x16"] if args.multi_pod_only else list(MESHES))
    n_ok = n_fail = 0
    for arch in archs:
        cfg = get_arch(arch)
        shapes = ([SHAPE_SETS[args.shape]] if args.shape
                  else applicable_shapes(cfg))
        for mesh_name in meshes:
            for shape in shapes:
                rec = run_cell(arch, shape.name, mesh_name, args.out,
                               overwrite=args.overwrite)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"dryrun done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
