"""Multi-process harness and rank bodies for the port's sharded tests
(`test_torch_distributed.py` on the CPU over gloo,
`test_torch_distributed_gpu.py` on 4 cards over NCCL). Imports torch
and `repro_torch` only: each rank is a fresh interpreter, and the JAX
reference runs in the test's own process.

`run_ranks(target, world, ...)` starts `world` processes (spawn), each
joining a process group at `tcp://127.0.0.1:<free port>` with its rank
and one intra-op thread, runs `target(rank, **kw)` and sends back what
it returns; a rank that raises fails the call with its traceback, and
one that has not answered within `timeout` seconds fails it too. Every
rank destroys its group in a `finally`, and every process is joined (or
killed) before `run_ranks` returns. `run_alone(target, ...)` runs
`target(**kw)` the same way in one fresh process with no group: the
fake worlds of the dry run (`launch.mesh.fake_world`) are made there,
never in the test's own process, where a leftover group would change
what later tests see.
"""
from __future__ import annotations

import dataclasses
import queue
import socket
import time
import traceback

import numpy as np
import torch

TIMEOUT = 180


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(target, rank, world, port, backend, kw, out):
    import datetime
    import warnings

    import torch.distributed as dist
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    try:
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
    except BaseException:
        out.put((rank, "err", traceback.format_exc()))
        return
    try:
        out.put((rank, "ok", target(rank, **kw)))
    except BaseException:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _other_errors(out, wait: float) -> str:
    """The tracebacks other ranks send within `wait` seconds of a first
    one (the rank that failed first may not be the one that reported
    first)."""
    msgs = []
    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        try:
            rank, status, payload = out.get(timeout=0.5)
        except queue.Empty:
            continue
        if status == "err":
            msgs.append(f"\n--- rank {rank} failed too:\n{payload}")
    return "".join(msgs)


def run_ranks(target, world: int = 4, *, backend: str = "gloo",
              timeout: float = TIMEOUT, **kw) -> list:
    """`target(rank, **kw)` on `world` ranks; their results by rank. A
    free port taken by another process between its probe and the group's
    start is probed again, once."""
    try:
        return _run_ranks(target, world, backend, timeout, kw)
    except RuntimeError as e:
        if "address already in use" not in str(e).lower():
            raise
    return _run_ranks(target, world, backend, timeout, kw)


def _run_ranks(target, world, backend, timeout, kw) -> list:
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, port, backend, kw, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{target.__name__}: ranks "
                                   f"{sorted(set(range(world)) - set(results))}"
                                   f" gave no answer within {timeout} s")
            try:
                rank, status, payload = out.get(timeout=min(left, 2.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"{target.__name__}: ranks {dead} "
                                       f"died without an answer")
                continue
            if status == "err":
                raise RuntimeError(f"{target.__name__}: rank {rank} "
                                   f"failed:\n{payload}"
                                   + _other_errors(out, 5.0))
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=15)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def _alone_main(target, kw, out):
    import warnings
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    try:
        out.put(("ok", target(**kw)))
    except BaseException:
        out.put(("err", traceback.format_exc()))


def run_alone(target, *, timeout: float = TIMEOUT, **kw):
    """`target(**kw)` in one fresh process (spawn); its result, or its
    traceback raised as a `RuntimeError`."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_alone_main, args=(target, kw, out))
    proc.start()
    try:
        status, payload = out.get(timeout=timeout)
    except queue.Empty:
        raise TimeoutError(f"{target.__name__}: no answer within "
                           f"{timeout} s") from None
    finally:
        proc.join(timeout=15)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if status == "err":
        raise RuntimeError(f"{target.__name__} failed:\n{payload}")
    return payload


# ------------------------------------------------------------- rank bodies

def _np(x):
    from repro_torch.parallel.sharding import full
    return full(x).detach().float().cpu().numpy()


def canon(placements) -> list:
    """Placements as "R", "S<dim>" or "P" (independent of the torch
    version's spelling)."""
    return ["R" if p.is_replicate() else f"S{p.dim}" if p.is_shard()
            else "P" for p in placements]


def _np_tree(tree):
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    return dict(zip(flat_paths(tree), [_np(x) for x in tree_leaves(tree)]))


def _cfg(arch: str, **moe):
    """The reduced config, its MoE fields replaced by `moe`."""
    from repro_torch.common.config import get_arch
    cfg = get_arch(arch).reduced()
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _batch(cfg, b, s, seed=0):
    from repro_torch.data import SyntheticLMData
    kind = ("encdec" if cfg.family == "encdec"
            else ("embeds" if cfg.frontend == "embed" else "tokens"))
    return SyntheticLMData(cfg.vocab_size, batch=b, seq=s, seed=seed,
                           embed_dim=cfg.d_model, kind=kind).batch_at(0)


def _context(model, device):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import (LOGICAL_RULES_SINGLE_POD,
                                               sharding_context)
    mesh = make_host_mesh(model, device=device)
    return mesh, sharding_context(mesh, LOGICAL_RULES_SINGLE_POD, set())


def _moe_drops(params, cfg, dims, h):
    """`dropped` of the first MoE block on `h`."""
    from repro_torch.common.treeutil import tree_index
    from repro_torch.models import blocks as B
    lp = tree_index(params["layers"], 0)
    return B.apply_moe(lp["moe"], h, dims)[2]


def step_worker(rank, *, arch, model, state_np=None, device="cpu",
                batch=(4, 32), seed=0, lr=1e-3, moe=None, opt=None):
    """One train step of `arch`'s reduced config (state from `state_np`,
    the reference's converted, else drawn from `seed`), first on this
    rank alone with no context, then sharded on a (world // model,
    model) mesh (`moe`: MoE fields to replace; `opt`: `OptConfig`
    fields beside lr and its schedule). Returns on rank 0 the loss, every gradient leaf, and
    the state after the step, of both (numpy, the sharded ones whole),
    and the placements of the sharded gradients."""
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    from repro_torch.launch import specs as SP
    from repro_torch.models.convert import state_from_numpy
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.parallel.sharding import distribute
    from repro_torch.train.step import (make_grad_fn, make_state,
                                        make_train_step)
    cfg = _cfg(arch, **(moe or {}))
    dims = make_dims(cfg, tp=model, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig(lr=lr, warmup_steps=1, total_steps=10, **(opt or {}))
    if state_np is not None:
        state = state_from_numpy(state_np, device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        state = make_state(gen, cfg, dims, ocfg, device=device)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in _batch(cfg, *batch).items()}
    grads_of = make_grad_fn(cfg, dims)
    step = make_train_step(cfg, dims, ocfg, device=device)
    loss1, _, g1 = grads_of(state["params"], batch)
    new1, m1 = step(state, batch)
    if cfg.moe is not None:
        h = torch.randn(batch["tokens"].shape + (cfg.d_model,),
                        generator=torch.Generator(device=device).manual_seed(1),
                        device=device)
        drop1 = float(_moe_drops(state["params"], cfg, dims, h))
    mesh, ctx = _context(model, device)
    with ctx:
        _, specs = SP.state_shapes_and_specs(cfg, dims, "train", None,
                                             opt_cfg=ocfg)
        st = distribute(state, SP.to_shardings(mesh, specs))
        bt = distribute(batch, SP.to_shardings(
            mesh, SP.batch_spec_axes(cfg, batch)))
        loss4, _, g4 = grads_of(st["params"], bt)
        new4, m4 = step(st, bt)
        drops = None
        if cfg.moe is not None:
            h4 = distribute(h, SP.to_shardings(mesh, ("batch", "seq", None)))
            drops = (drop1,
                     float(_np(_moe_drops(st["params"], cfg, dims, h4))))
        out = {"loss1": float(loss1), "loss4": float(_np(loss4)),
               "step_loss1": float(m1["loss"]),
               "step_loss4": float(_np(m4["loss"])),
               "g1": _np_tree(g1), "g4": _np_tree(g4),
               "new1": _np_tree(new1), "new4": _np_tree(new4),
               "g_placements": {p: canon(g.placements)
                                for p, g in zip(flat_paths(g4),
                                                tree_leaves(g4))},
               "p_placements": {p: canon(g.placements)
                                for p, g in zip(flat_paths(st["params"]),
                                                tree_leaves(st["params"]))},
               "loss_placements": canon(loss4.placements),
               "drops": drops}
    return out if rank == 0 else None


def _pad_kv(state, length):
    """A prefill's decode state with its self-attention caches ("k",
    "v": [L, B, S, Hkv, dh]) zero-padded to `length` positions."""
    out = dict(state)
    for key in ("k", "v"):
        if key in state:
            x = state[key]
            pad = torch.zeros(x.shape[:2] + (length - x.shape[2],)
                              + x.shape[3:], dtype=x.dtype, device=x.device)
            out[key] = torch.cat([x, pad], dim=2)
    return out


def families_worker(rank, *, archs, **kw):
    """`family_worker` for each of `archs`, in one process group."""
    return {a: family_worker(rank, arch=a, **kw) for a in archs}


def family_worker(rank, *, arch, model, device="cpu", batch=(4, 32),
                  seed=0):
    """`train_loss`, `prefill` and one `decode_step` of `arch`'s reduced
    config with no context and under a (world // model, model) mesh:
    params and batch distributed by their specs, the decode step given
    the one-process prefill's state (caches padded by 4 positions)
    distributed by `decode_state_specs`, and its greedy token. Returns
    on rank 0 each output of both, the sharded ones whole."""
    from repro_torch.launch import specs as SP
    from repro_torch.models.api import get_model
    from repro_torch.models.dims import make_dims
    from repro_torch.parallel.sharding import distribute
    cfg = _cfg(arch)
    mod = get_model(cfg)
    dims = make_dims(cfg, tp=model, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    params = mod.init(torch.Generator(device=device).manual_seed(seed), cfg,
                      dims, device)
    fb = {k: torch.as_tensor(v, device=device)
          for k, v in _batch(cfg, *batch).items()}
    pb = {k: v for k, v in fb.items() if k != "labels"}
    if cfg.family == "encdec":     # a BOS prefill, then position 1
        pb["tokens"] = pb["tokens"][:, :1]
    pos = pb["tokens"].shape[1] if "tokens" in pb else batch[1]

    loss, _ = mod.train_loss(params, fb, cfg, dims)
    logits, state = mod.prefill(params, pb, cfg, dims)
    dstate0 = _pad_kv(state, pos + 4)
    token = torch.argmax(logits, -1).to(torch.int32)
    dlogits, dstate = mod.decode_step(params, dstate0, cfg, dims,
                                      token=token, pos=pos)
    one = {"loss": _np(loss), "logits": _np(logits),
           "state": _np_tree(state), "dlogits": _np(dlogits),
           "dstate": _np_tree(dstate)}
    mesh, ctx = _context(model, device)
    with ctx:
        def put(tree, axes):
            return distribute(tree, SP.to_shardings(mesh, axes))

        _, psp = SP.state_shapes_and_specs(cfg, dims, "prefill", None)
        p4 = put(params, psp)
        loss4, _ = mod.train_loss(p4, put(fb, SP.batch_spec_axes(cfg, fb)),
                                  cfg, dims)
        logits4, state4 = mod.prefill(
            p4, put(pb, SP.batch_spec_axes(cfg, pb)), cfg, dims)
        dlogits4, dstate4 = mod.decode_step(
            p4, put(dstate0, mod.decode_state_specs(cfg, dims)), cfg, dims,
            token=put(token, ("batch",)), pos=pos)
        sharded = {"loss": _np(loss4), "logits": _np(logits4),
                   "state": _np_tree(state4), "dlogits": _np(dlogits4),
                   "dstate": _np_tree(dstate4)}
    return {"one": one, "sharded": sharded} if rank == 0 else None


def moe_shard_worker(rank, *, model, device="cpu", seed=0,
                     capacity_factor=0.5):
    """The MoE block of the reduced qwen3-moe at a capacity factor that
    binds (tokens are dropped), under a (world // model, model) mesh,
    against the reference's per-shard semantics run here on one rank:
    `_moe_local_body` on each data shard's tokens with that shard's
    capacity, the outputs concatenated, aux and dropped averaged over
    the shards."""
    from repro_torch.common.treeutil import tree_index
    from repro_torch.launch import specs as SP
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.models.api import get_model
    from repro_torch.models.dims import make_dims
    from repro_torch.parallel.sharding import distribute, full
    cfg = _cfg("qwen3-moe-235b-a22b", capacity_factor=capacity_factor)
    m = cfg.moe
    dims = make_dims(cfg, tp=model, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = get_model(cfg).init(gen, cfg, dims, device)
    lp = tree_index(params["layers"], 0)["moe"]
    h = torch.randn((8, 16, cfg.d_model), generator=gen, device=device)
    data = torch.distributed.get_world_size() // model
    x = L.rmsnorm(h, lp["ln"], cfg.norm_eps)
    cap = B._moe_capacity((h.shape[0] // data) * h.shape[1], m)
    ys, auxs, drops = [], [], []
    for xs in torch.chunk(x, data):
        y, aux, dropped = B._moe_local_body(
            xs, lp["router"], lp["we_i"], lp["we_g"], lp["we_o"],
            moe_cfg=m, expert_offset=0, capacity=cap)
        ys.append(y)
        auxs.append(aux)
        drops.append(dropped)
    y = torch.cat(ys)
    if m.shared_expert_ff:
        sh = lp["shared"]
        y = y + L.gated_mlp(x, sh["wi"], sh["wg"], sh["wd"])
    want = (h + y, torch.stack(auxs).mean() * m.router_aux_weight,
            torch.stack(drops).mean())
    mesh, ctx = _context(model, device)
    with ctx:
        _, psp = SP.state_shapes_and_specs(cfg, dims, "prefill", None)
        p4 = distribute(params, SP.to_shardings(mesh, psp))
        h4 = distribute(h, SP.to_shardings(mesh, ("batch", "seq", None)))
        got = B.apply_moe(tree_index(p4["layers"], 0)["moe"], h4, dims)
        got = [full(t) for t in got]
    if rank:
        return None
    return {"want": [t.detach().cpu().numpy() for t in want],
            "got": [t.detach().cpu().numpy() for t in got]}


def restore_worker(rank, *, ckpt_dirs, model, out_dir, device="cpu"):
    """The reference's `test_elastic_restore_across_device_counts` on the
    port: each checkpoint of `ckpt_dirs` (written by one process)
    restored on a (world // model, model) mesh with
    `shardings=to_shardings(...)` of the reduced qwen2-0.5b's train
    specs at tp=model. Returns on every rank, per checkpoint, each leaf's
    local shard, its placements, the mesh coordinate and the whole
    tensor; and it saves the sharded state back (one directory a rank
    under `out_dir`), so that a sharded save can be held to the
    one-process bytes."""
    import os

    from repro_torch.checkpoint import CheckpointConfig, CheckpointEngine
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    from repro_torch.launch import specs as SP
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.train.step import make_state
    cfg = _cfg("qwen2-0.5b")
    mesh, ctx = _context(model, device)
    out = {"coord": list(mesh.get_coordinate()),
           "mesh_shape": list(mesh.shape), "ckpts": []}
    with ctx:
        dims = make_dims(cfg, tp=model, param_dtype=torch.float32,
                         compute_dtype=torch.float32)
        template = make_state(torch.Generator(device=device).manual_seed(0),
                              cfg, dims, OptConfig(), device=device)
        _, specs = SP.state_shapes_and_specs(cfg, dims, "train", None)
        shard = SP.to_shardings(mesh, specs)
        for i, d in enumerate(ckpt_dirs):
            eng = CheckpointEngine(CheckpointConfig(directory=d, interval=1,
                                                    n_banks=3))
            state, step = eng.restore(template, shardings=shard)
            leaves = tree_leaves(state)
            whole = [_np(x) for x in leaves]      # a collective: every rank
            out["ckpts"].append({
                "step": step,
                "paths": flat_paths(state),
                "local": [x.to_local().detach().cpu().numpy()
                          for x in leaves],
                "placements": [canon(x.placements) for x in leaves],
                "full": whole if rank == 0 else None})
            save = CheckpointEngine(CheckpointConfig(
                directory=os.path.join(out_dir, f"ckpt{i}_rank{rank}"),
                interval=1, n_banks=3))
            save.force_snapshot(step, state)
            save.flush_all_now()
            save.wait()
    return out


def order_worker(rank, *, device="cpu"):
    """A [8, 3] tensor distributed on a (pod=2, data=2, model=1) mesh
    under the multi-pod rules, its rows on ("pod", "data"): each rank's
    rows, its mesh coordinate, and the placements."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import specs as SP
    from repro_torch.parallel.sharding import (LOGICAL_RULES_MULTI_POD,
                                               distribute, sharding_context)
    mesh = init_device_mesh(torch.device(device).type, (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    x = torch.arange(24, dtype=torch.float32, device=device).reshape(8, 3)
    with sharding_context(mesh, LOGICAL_RULES_MULTI_POD, set()):
        sh = SP.to_shardings(mesh, ("batch", None))
        d = distribute(x, sh)
    return {"coord": list(mesh.get_coordinate()),
            "rows": d.to_local().cpu().numpy(),
            "placements": canon(d.placements)}


def mesh_errors_worker(rank, *, device="cpu"):
    """The mesh functions' refusals on a world of 4: the production meshes
    name the world size, a model axis that does not divide it raises."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    out = {}
    for name, fn in (("single", lambda: make_production_mesh(device=device)),
                     ("multi", lambda: make_production_mesh(
                         multi_pod=True, device=device)),
                     ("host3", lambda: make_host_mesh(3, device=device))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    mesh = make_host_mesh(2, device=device)
    out["host2"] = (list(mesh.shape), list(mesh.mesh_dim_names))
    return out


def expected_local(full, placements, coord, mesh_shape):
    """This rank's block of the numpy array `full` under `placements`
    (`canon`'s spelling): each "S<d>" mesh dimension splits dimension d
    into equal blocks, outer mesh dimensions first."""
    x = full
    for i, pl in enumerate(placements):
        if pl.startswith("S"):
            x = np.split(x, mesh_shape[i], axis=int(pl[1:]))[coord[i]]
    return x


def np_close(got, want, rel, atol=0.0) -> tuple:
    """(max abs difference, its bar): the bar `rel` of the largest |want|
    plus `atol`."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(g - w).max()) if g.size else 0.0
    bar = rel * (float(np.abs(w).max()) if w.size else 0.0) + atol
    return err, bar


# ------------------------------------------------- the dry run's fake worlds

def _counts(ops) -> dict:
    """The collective fields of an `OpAnalysis`, and its roofline."""
    return {"counts": ops.collective_counts, "wire": ops.collective_wire,
            "wire_bytes": ops.wire_bytes, "links": ops.collective_links,
            "link_wire": ops.link_wire, "roofline": ops.roofline(),
            "n_ops": ops.n_instructions, "flops": ops.flops,
            "argument_bytes": ops.argument_bytes,
            "output_bytes": ops.output_bytes}


def count_step_worker(rank=0, *, model, device="cpu", fake=False):
    """`analyze_ops` of one train step of the reduced qwen2-0.5b (f32,
    batch 4 x 32) on a (world // model, model) mesh of `device`: on a
    real group, over this rank's real state (`make_state`), or, with
    `fake`, in the fake world of `world` ranks made here, over the `meta`
    state of `launch.specs` laid out the same way. Returns rank 0's
    collective counts, wire bytes and links."""
    import torch.distributed as dist

    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.parallel.op_analysis import analyze_ops
    from repro_torch.parallel.sharding import distribute
    from repro_torch.train.step import make_state, make_train_step
    cfg = _cfg("qwen2-0.5b")
    dims = make_dims(cfg, tp=model, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig()

    def count(on):
        batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 4, 32).items()}
        if on == "meta":
            state, _ = SP.state_shapes_and_specs(cfg, dims, "train", None,
                                                 opt_cfg=ocfg)
            batch = {k: torch.empty_like(v, device="meta")
                     for k, v in batch.items()}
        else:
            state = make_state(torch.Generator(device=on).manual_seed(0),
                               cfg, dims, ocfg, device=on)
            batch = {k: v.to(on) for k, v in batch.items()}
        mesh, ctx = _context(model, device)
        with ctx:
            _, specs = SP.state_shapes_and_specs(cfg, dims, "train", None,
                                                 opt_cfg=ocfg)
            st = distribute(state, SP.to_shardings(mesh, specs))
            bt = distribute(batch, SP.to_shardings(
                mesh, SP.batch_spec_axes(cfg, batch)))
            return _counts(analyze_ops(make_train_step(cfg, dims, ocfg,
                                                       device=on), st, bt))

    if fake:
        with fake_world(4):
            out = count("meta")
            out["backend"] = dist.get_backend()
        return out
    out = count(device)
    out["backend"] = dist.get_backend()
    return out if rank == 0 else None


def redistribute_worker():
    """One redistribution at a time on the fake (data=16, model=16) world,
    counted by `analyze_ops`: a [64, 32] float32 tensor Shard(0) over
    'model' made Replicate, a Partial over 'model' made Replicate, and
    Shard(0) made Shard(1) over 'model'; and a plain call."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)

    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.parallel.op_analysis import analyze_ops
    R = Replicate()
    x = torch.empty(64, 32, device="meta")
    with fake_world(256):
        mesh = make_production_mesh()
        sh = distribute_tensor(x, mesh, [R, Shard(0)])
        part = DTensor.from_local(torch.empty(64, 32, device="meta"), mesh,
                                  [R, Partial()])
        return {
            "gather": _counts(analyze_ops(
                lambda t: t.redistribute(mesh, [R, R]), sh)),
            "reduce": _counts(analyze_ops(
                lambda t: t.redistribute(mesh, [R, R]), part)),
            "all_to_all": _counts(analyze_ops(
                lambda t: t.redistribute(mesh, [R, Shard(1)]), sh)),
            "plain": _counts(analyze_ops(lambda t: (t * 2).sum(), x))}


def fake_world_worker():
    """`fake_world`'s refusal of a group already initialized (a gloo
    group of one, which stays), and that it leaves no group behind, on a
    normal exit and on an exception."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_world
    out = {}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        with fake_world(256):
            out["replaced"] = True
    except RuntimeError as e:
        out["refused"] = str(e)
    out["kept"] = (dist.is_initialized(), dist.get_backend(),
                   dist.get_world_size())
    dist.destroy_process_group()
    with fake_world(512):
        out["inside"] = (dist.get_backend(), dist.get_world_size(),
                         dist.get_rank())
    out["after_exit"] = dist.is_initialized()
    try:
        with fake_world(256):
            raise KeyError("inside")
    except KeyError:
        pass
    out["after_error"] = dist.is_initialized()
    return out


#: small shapes for the dry run's reduced cells (the batch divides the
#: multi-pod mesh's 32 batch ways, the sequence its 16 model ways)
TINY_SHAPES = {"tiny_train": (64, 32, "train"),
               "tiny_decode": (64, 32, "decode")}


def dryrun_cli_worker(*, runs, moe_experts=16):
    """`launch.dryrun.main(argv)` for each (argv, out_dir) of `runs`, in
    this one process, on the reduced configs (an MoE's expert count set
    to `moe_experts`, which the model ways divide) and `TINY_SHAPES`.
    Returns each run's exit code and the records it wrote, by file."""
    import glob
    import json
    import os

    from repro_torch.common import config as C
    from repro_torch.launch import dryrun as D
    for name, (s, b, kind) in TINY_SHAPES.items():
        C.SHAPE_SETS[name] = C.ShapeConfig(name, s, b, kind)
    full = D.get_arch

    def reduced(name):
        cfg = full(name).reduced()
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_experts=moe_experts))
        return cfg
    D.get_arch = reduced
    out = []
    for argv, out_dir in runs:
        rc = D.main(list(argv) + ["--out", out_dir])
        recs = {}
        for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
            with open(path) as f:
                recs[os.path.basename(path)] = json.load(f)
        out.append({"rc": rc, "records": recs})
    return out
