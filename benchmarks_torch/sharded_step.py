#!/usr/bin/env python3
"""A sharded train step on 1, 2 and 4 H100s:

    python3 benchmarks_torch/sharded_step.py [--cards N] [--out FILE]

qwen2.5-3b at full width, batch 2 x 512, f32, one `make_train_step`
step (AdamW with a factored second moment, so that the one-card step
fits one 80 GB card, as in `tests/test_torch_distributed_gpu.py`), from
the state of a CUDA generator seeded 0 and `SyntheticLMData(seed=0)`:

  * 1 card: no mesh (the unsharded step);
  * 2 cards: meshes (data=2, model=1) and (data=1, model=2);
  * 4 cards: meshes (data=2, model=2) and (data=1, model=4).

Each configuration runs in processes of its own, one card a rank, over
NCCL (`tcp://127.0.0.1:<free port>`), and reports: the step's ms on rank
0 (CUDA events around one step, the median of 5 after 2 warm-ups; every
rank's median beside it), each card's peak memory
(`max_memory_allocated` over the timed steps), kernel E's launches on
each card in one step, and from `torch.profiler` over one more step
(every rank runs it; rank 0's is reported) the device time in NCCL
kernels, in kernel E and in the rest, beside the step's wall time.

Then the dry run's qwen2.5-14b train cell on 4 cards, mesh (1, 4), cut
to 1 x 512 tokens (the cell's optimizer: AdamW with float32 moments):
params drawn leaf by leaf straight into their shards (a CUDA generator
seeded 0; norm weights 1), the gradients' ms and peak, then the whole
step's ms and peak, or the out-of-memory error and the peak reached.

`--cards` caps the cards used (default: all, at most 4). Prints the
card's name and power limit, then one JSON object a line; `--out`
writes them all to FILE.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import socket
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

ARCH, BATCH = "qwen2.5-3b", (2, 512)
BIG_ARCH, BIG_BATCH = "qwen2.5-14b", (1, 512)
WARMUP, REPS = 2, 5
TIMEOUT = 480


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(fn, rank, world, port, kw, out):
    import datetime

    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out.put((rank, "ok", fn(rank, **kw)))
    except BaseException:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run(fn, world: int, **kw) -> list:
    """`fn(rank, **kw)` on `world` ranks, one card each; their results."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, kw, out))
             for r in range(world)]
    for p in procs:
        p.start()
    res, deadline = {}, time.monotonic() + TIMEOUT
    try:
        while len(res) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} cards")
            try:
                rank, status, payload = out.get(timeout=2.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError(f"{fn.__name__}: a rank died")
                continue
            if status == "err":
                raise RuntimeError(f"{fn.__name__} rank {rank}:\n{payload}")
            res[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [res[r] for r in range(world)]


def _batch(cfg, b, s):
    from repro_torch.data import SyntheticLMData
    data = SyntheticLMData(cfg.vocab_size, batch=b, seq=s, seed=0)
    return {k: torch.as_tensor(v, device="cuda")
            for k, v in data.batch_at(0).items()}


def _time(step, state, batch) -> list:
    """ms of each of `REPS` steps after `WARMUP` (CUDA events)."""
    for _ in range(WARMUP):
        step(state, batch)
    out = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(state, batch)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _profile(step, state, batch) -> dict:
    """Device ms of one step by kind (NCCL kernels, kernel E, the rest)
    beside its synchronized wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kinds = {"nccl": 0.0, "kernel_E": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = ("nccl" if "nccl" in name else
                "kernel_E" if "flash_attention" in name else "other")
        kinds[kind] += e.time_range.elapsed_us() / 1e3
    busy = sum(kinds.values())
    return {"wall_ms": wall, "device_ms": busy,
            **{f"{k}_ms": v for k, v in kinds.items()},
            "nccl_share_of_device": kinds["nccl"] / busy if busy else None,
            "device_busy_share_of_wall": busy / wall if wall else None}


def dense_case(rank, *, model, arch=ARCH):
    """One configuration of `arch`'s step; `model` None: no mesh."""
    import torch.distributed as dist

    from repro_torch.common.config import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.parallel.sharding import (LOGICAL_RULES_SINGLE_POD,
                                               distribute, sharding_context)
    from repro_torch.train.step import make_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch)
    dims = make_dims(cfg, tp=model or 1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                     factored_v=True)
    state = make_state(torch.Generator(device="cuda").manual_seed(0), cfg,
                       dims, ocfg, device="cuda")
    batch = _batch(cfg, *BATCH)
    step = make_train_step(cfg, dims, ocfg, device="cuda")
    ctx, mesh = contextlib.nullcontext(), None
    if model is not None:
        mesh = make_host_mesh(model, device="cuda")
        ctx = sharding_context(mesh, LOGICAL_RULES_SINGLE_POD, set())
    with ctx:
        if mesh is not None:
            _, specs = SP.state_shapes_and_specs(cfg, dims, "train", None,
                                                 opt_cfg=ocfg)
            state = distribute(state, SP.to_shardings(mesh, specs))
            batch = distribute(batch, SP.to_shardings(
                mesh, SP.batch_spec_axes(cfg, batch)))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = fa.LAUNCHES
        try:
            step(state, batch)
        except torch.OutOfMemoryError as e:
            out = {"oom": str(e).splitlines()[0],
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del state, batch
            return out
        torch.cuda.synchronize()
        e_launches = fa.LAUNCHES - before
        ms = _time(step, state, batch)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = _profile(step, state, batch)  # a step: every rank runs it
    if dist.is_initialized():
        dist.barrier()
    return {"ms": ms, "peak_gib": peak, "e_launches": e_launches,
            "profile": prof if rank == 0 else None}


def _random_sharded_params(cfg, dims, mesh, gen):
    """The params of `cfg` drawn leaf by leaf straight into their shards:
    each leaf normal(0, 0.02) from `gen` (norm weights 1), distributed,
    the whole leaf freed before the next is drawn."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.common.treeutil import (flat_paths, tree_flatten,
                                             tree_unflatten)
    from repro_torch.launch import specs as SP
    meta, specs = SP.state_shapes_and_specs(cfg, dims, "prefill", None)
    shard = SP.to_shardings(mesh, specs)
    leaves, treedef = tree_flatten(meta)
    shards = tree_flatten(shard)[0]
    out = []
    for path, x, sh in zip(flat_paths(meta), leaves, shards):
        if path.endswith("ln"):
            whole = torch.ones(x.shape, dtype=x.dtype, device="cuda")
        else:
            whole = torch.randn(x.shape, generator=gen, device="cuda",
                                dtype=torch.float32).mul_(0.02).to(x.dtype)
        out.append(distribute_tensor(whole, mesh, list(sh.placements)))
        del whole
    return tree_unflatten(treedef, out)


def big_case(rank, *, model, arch=BIG_ARCH):
    """`arch`'s train cell cut to `BIG_BATCH` on (world // model, model):
    the gradients' ms and peak, then the step's, or its OOM."""
    from repro_torch.common.config import get_arch
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import init_opt
    from repro_torch.parallel.sharding import (LOGICAL_RULES_SINGLE_POD,
                                               distribute, sharding_context)
    from repro_torch.train.step import make_grad_fn, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch)
    dims = make_dims(cfg, tp=model, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = SP.opt_config_for(cfg)
    mesh = make_host_mesh(model, device="cuda")
    out = {"mesh": list(mesh.shape), "optimizer": str(ocfg)}
    with sharding_context(mesh, LOGICAL_RULES_SINGLE_POD, set()):
        params = _random_sharded_params(
            cfg, dims, mesh, torch.Generator(device="cuda").manual_seed(0))
        state = {"params": params, "opt": init_opt(params, ocfg)}
        batch = _batch(cfg, *BIG_BATCH)
        batch = distribute(batch, SP.to_shardings(
            mesh, SP.batch_spec_axes(cfg, batch)))
        out["state_gib"] = torch.cuda.memory_allocated() / 2**30
        grads_of = make_grad_fn(cfg, dims)
        torch.cuda.reset_peak_memory_stats()
        try:
            out["grads_ms"] = _time(lambda s, b: grads_of(s["params"], b),
                                    state, batch)
            out["grads_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        except torch.OutOfMemoryError as e:
            out["grads_oom"] = str(e).splitlines()[0]
            out["grads_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            return out
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(cfg, dims, ocfg, device="cuda")
        try:
            out["step_ms"] = _time(step, state, batch)
            out["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        except torch.OutOfMemoryError as e:
            out["step_oom"] = str(e).splitlines()[0]
            out["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-big", action="store_true",
                    help="leave out the qwen2.5-14b cell")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sharded_step: no CUDA card", file=sys.stderr)
        return 2
    cards = min(args.cards, torch.cuda.device_count(), 4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    lines = [{"cards": smi[:cards], "torch": torch.__version__,
              "reps": REPS, "warmup": WARMUP}]
    print(json.dumps(lines[0]), flush=True)
    configs = [(1, None)] + [(2, m) for m in (1, 2) if cards >= 2] + [
        (4, m) for m in (2, 4) if cards >= 4]
    for world, model in configs:
        t0 = time.perf_counter()
        ranks = run(dense_case, world, model=model)
        r0 = ranks[0]
        line = {"case": ARCH, "batch": list(BATCH), "cards": world,
                "mesh": (None if model is None else
                         {"data": world // model, "model": model}),
                "seconds": round(time.perf_counter() - t0, 1)}
        if "oom" in r0:
            line.update(oom=r0["oom"],
                        peak_gib_by_card=[r["peak_gib"] for r in ranks])
        else:
            line.update(
                step_ms_median=statistics.median(r0["ms"]),
                step_ms_runs=r0["ms"],
                step_ms_median_by_rank=[statistics.median(r["ms"])
                                        for r in ranks],
                peak_gib_by_card=[r["peak_gib"] for r in ranks],
                e_launches_by_card=[r["e_launches"] for r in ranks],
                profile_rank0=r0["profile"])
        lines.append(line)
        print(json.dumps(line), flush=True)
    if cards >= 4 and not args.skip_big:
        t0 = time.perf_counter()
        ranks = run(big_case, 4, model=4)
        line = {"case": BIG_ARCH, "batch": list(BIG_BATCH), "cards": 4,
                "by_card": ranks, "seconds": round(time.perf_counter() - t0,
                                                   1)}
        for key in ("grads_ms", "step_ms"):
            if key in ranks[0]:
                line[key + "_median"] = statistics.median(ranks[0][key])
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
