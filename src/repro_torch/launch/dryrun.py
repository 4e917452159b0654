"""One-card dry run: every (arch x shape) cell's step on `meta`, with its
memory, op counts and roofline on one H100, before any chip time is spent.

The counterpart of the reference's `launch/dryrun.py`, which lowers and
compiles each cell for a TPU mesh. Here the step runs eagerly on `meta`
tensors (shapes only, nothing computed or allocated) under
`parallel.op_analysis.analyze_ops`; the models take their plain route on
`meta`, as the reference's dry run lowers its models' plain path.

Usage:
  python -m repro_torch.launch.dryrun                         # full matrix
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k

Per cell, writes results/dryrun_torch/<arch>__<shape>__h100x1.json with the
reference's keys where their meaning holds: ``memory`` (``argument_gb``,
``output_gb``; ``temp_gb`` and ``peak_gb`` null: `meta` allocates nothing,
so the step's temporaries are not known), ``ops`` (the reference's
``hlo``), ``roofline``, ``model_flops_global``, ``useful_flop_ratio``,
``roofline_fraction``; and ``devices`` 1 and ``fits_one_card`` (argument
+ output within the card's 80 GB). A decode cell runs one step at the
last position of a full `seq_len` cache.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.common.config import (SHAPE_SETS, applicable_shapes,
                                       get_arch, list_archs)
from repro_torch.launch import specs as SP
from repro_torch.models.api import get_model
from repro_torch.models.dims import make_dims
from repro_torch.parallel.op_analysis import (HBM_BYTES, PEAK_FLOPS,
                                              analyze_ops)
from repro_torch.train.step import make_train_step

MESH = "h100x1"


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
    mod = get_model(cfg)
    state, _ = SP.state_shapes_and_specs(cfg, dims, shape.kind, shape)
    if shape.kind == "train":
        batch = SP.batch_specs(cfg, shape, with_labels=True)
        step = make_train_step(cfg, dims, SP.opt_config_for(cfg),
                               accum=SP.accum_for(cfg, shape),
                               device=SP.META)
        return step, (state, batch)
    if shape.kind == "prefill":
        batch = SP.batch_specs(cfg, shape, with_labels=False)

        def pf(params, b):
            return mod.prefill(params, b, cfg, dims)
        return pf, (state, batch)
    b = shape.global_batch
    if cfg.frontend == "embed" and cfg.family != "encdec":
        tok = {"embed": SP.meta_tensor((b, cfg.d_model), torch.bfloat16)}
    else:
        tok = {"token": SP.meta_tensor((b,), torch.int32)}

    def dec(sd, tk):
        return mod.decode_step(sd["params"], sd["state"], cfg, dims,
                               pos=shape.seq_len - 1, **tk)
    return dec, (state, tok)


def run_cell(arch: str, shape_name: str, out_dir: str,
             overwrite: bool = False) -> dict:
    cell_id = f"{arch}__{shape_name}__{MESH}"
    path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(path) and not overwrite:
        with open(path) as f:
            return json.load(f)
    cfg = get_arch(arch)
    shape = SHAPE_SETS[shape_name]
    dims = make_dims(cfg, tp=1)
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
           "kind": shape.kind, "ok": False}
    t0 = time.time()
    try:
        fn, args = cell_step(cfg, dims, shape)
        ops = analyze_ops(fn, *args)
        mf = model_flops(cfg, shape)
        roof = ops.roofline()
        arg_gb, out_gb = ops.argument_bytes / 1e9, ops.output_bytes / 1e9
        peak = PEAK_FLOPS[str(dims.compute_dtype).replace("torch.", "")]
        rec.update({
            "ok": True,
            "analyze_s": round(time.time() - t0, 1),
            "devices": 1,
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
                "n_ops": ops.n_instructions,
            },
            "roofline": roof,
            "model_flops_global": mf,
            "useful_flop_ratio": mf / ops.flops if ops.flops else 0.0,
            "roofline_fraction": ((mf / peak) / roof["bound_s"]
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
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list_archs()
    n_ok = n_fail = 0
    for arch in archs:
        cfg = get_arch(arch)
        shapes = ([SHAPE_SETS[args.shape]] if args.shape
                  else applicable_shapes(cfg))
        for shape in shapes:
            rec = run_cell(arch, shape.name, args.out,
                           overwrite=args.overwrite)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"dryrun done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
