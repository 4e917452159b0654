"""The multi-card slice on 4 H100s (`gpu` marker; each test skips with
fewer than 4 cards): 4 processes a test over NCCL, one card a rank
(`_torch_dist_workers.run_ranks`, backend "nccl"), at full width, f32.

  * qwen2.5-3b, batch 2 x 512, one `make_train_step` step on meshes
    (data=2, model=2) and (data=1, model=4) against the same step on one
    card (rank 0's, before the mesh is built): the loss, every gradient
    leaf (`make_grad_fn`), m and v after the step at `MODEL_REL` = 1e-4
    of the one-card leaf's largest magnitude, params after the step
    within `param_bar` (the difference the gradient's bar can make
    through AdamW's first step, factored v included); every gradient in
    its param's
    placements; kernel E launched on every rank as often as on one card
    (its local heads through `local_map`). The whole f32 step does not
    fit one 80 GB card (`benchmarks_torch/sharded_step.py` records the
    out-of-memory error in the eager AdamW update), so the one-card
    reference is its gradients on the card and the same `apply_updates`
    on the CPU from them. The optimizer has a factored second moment,
    which puts the factored means' `Partial` resolution on the card.
  * qwen3-moe-235b-a22b at full width with its depth cut to 2 layers, on
    (1, 4) (32 experts a card): the loss and every gradient leaf against
    one card at `MODEL_REL`. One data shard, so capacity and aux are one
    card's.
  * mamba2-130m, batch 4 x 512, `prefill` on (2, 2) and (1, 4) (kernel F
    on 12 and 6 local SSD heads a rank): logits and every state leaf
    against one card at `MODEL_REL`; F launched once a layer on every
    rank.
  * A qwen2-0.5b train state saved by one card's process and restored
    sharded on (2, 2) with `shardings=to_shardings(...)`: every rank's
    local shard equals its slice of the saved leaf, every full tensor
    equals it exactly.
  * The dry run's count against NCCL: `analyze_ops` of the reduced
    qwen2-0.5b's train step (f32, 4 x 32) on a (2, 2) "cuda" mesh, in a
    fake 4-rank world on `meta` (one process, no card) and on the 4
    cards: rank 0's collectives by kind, their wire bytes and links,
    equal (a "cuda" mesh, as the dry run's: DTensor runs a
    Shard-to-Shard move there as an all-to-all, on gloo's "cpu" mesh as
    an all-gather). Ops and FLOPs differ by design: on the card kernel E's
    ctypes launch is invisible to the count, on `meta` its plain version
    is counted.

Run on a 4-card machine:
  PYTHONPATH=src:tests python -m pytest -q -m gpu --noconftest \\
      tests/test_torch_distributed_gpu.py
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import _torch_dist_workers as W

pytestmark = pytest.mark.gpu

MODEL_REL = 1e-4
CARDS = 4
TIMEOUT = 480


def _report(name, out, **extra):
    """One JSON line of what a test measured (printed; `-s` shows it)."""
    errs = out[0].get("errs") or {}
    print(json.dumps({"test": name, "max_abs_err": max(errs.values())
                      if errs else None, "leaves_held": len(errs),
                      "launches_by_card": [r.get("launches") for r in out],
                      "peak_gib_by_card": [r.get("peak_gib") for r in out],
                      **extra}), flush=True)


def _cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        pytest.skip(f"needs {CARDS} CUDA cards")


def param_bar(m, p, old, lr, rel=MODEL_REL):
    """The bar on a param `p` (before the step: `old`) after a first
    AdamW step whose gradient x = m / (1 - b1) is held at `rel`: the
    unfactored step moves an element by lr·x/(|x| + eps), which a
    difference d = `rel`·max|x| in x changes by up to
    lr·min(2, d·eps/(max(|x| - d, 0) + eps)²) (`test_torch_train_step.py`);
    a factored v divides x by a product of row and column means instead
    of |x|, which passes x's relative difference on to the move, so
    `rel` of the step's largest move is added; and `rel` of the leaf's
    largest |p|."""
    x = m.float().abs() / 0.1
    d = rel * float(x.max())
    eps = 1e-8
    move = torch.clamp_max(d * eps / (torch.clamp_min(x - d, 0.0) + eps) ** 2,
                           2.0)
    step = float((p.float() - old.float().to(p.device)).abs().max())
    return lr * move + rel * (step + float(p.float().abs().max()))


def _held(got, want, what, rel=MODEL_REL):
    g, w = got.float(), want.float().to(got.device)
    assert g.shape == w.shape, (what, tuple(g.shape), tuple(w.shape))
    err = float((g - w).abs().max()) if g.numel() else 0.0
    bar = rel * (float(w.abs().max()) if w.numel() else 0.0)
    assert bool(torch.isfinite(g).all()), what
    assert err <= bar, f"{what}: max abs difference {err} over {bar}"
    return err


def _launches(fn):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    before = (fa.LAUNCHES, ssd.LAUNCHES)
    out = fn()
    return out, {"flash_attention": fa.LAUNCHES - before[0],
                 "mamba2_ssd": ssd.LAUNCHES - before[1]}


def _hold_tree(got, want, what, on_rank0, errs, bar=None):
    """Each leaf of the DTensor tree `got` gathered whole (every rank)
    and held by rank 0 against the plain tree `want` (None elsewhere)."""
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    from repro_torch.parallel.sharding import full
    wants = dict(zip(flat_paths(want), tree_leaves(want))) if on_rank0 \
        else {}
    for path, g in zip(flat_paths(got), tree_leaves(got)):
        whole = full(g)
        if on_rank0:
            w = wants[path].to(whole.device)
            if bar is None:
                errs[f"{what}/{path}"] = _held(whole, w, f"{what} {path}")
            else:
                err = (whole.float() - w.float()).abs()
                b = bar(path, w)
                assert bool((err <= b).all()), (what, path,
                                                float((err - b).max()))
                errs[f"{what}/{path}"] = float(err.max())
        del whole


def _to_host(tree):
    from repro_torch.common.treeutil import tree_map
    return tree_map(lambda x: x.detach().to("cpu"), tree)


def dense_worker(rank, *, arch, model, batch=(2, 512), layers=None,
                 step=True):
    """One card's step (rank 0), then the sharded step on every rank;
    returns rank 0's errors and every rank's launches, peak memory and
    gradient placements."""
    import torch.distributed as dist

    from repro_torch.common.config import get_arch
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    from repro_torch.launch import specs as SP
    from repro_torch.models.api import get_model
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig, apply_updates
    from repro_torch.parallel.sharding import distribute, full
    from repro_torch.train.step import (make_grad_fn, make_state,
                                        make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dims = make_dims(cfg, tp=model, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                     factored_v=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if step:
        state = make_state(gen, cfg, dims, ocfg, device="cuda")
    else:                                  # gradients only: no optimizer
        state = {"params": get_model(cfg).init(gen, cfg, dims, "cuda")}
    data = W._batch(cfg, *batch)
    batch_t = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    grads_of = make_grad_fn(cfg, dims)
    train = make_train_step(cfg, dims, ocfg, device="cuda")
    ref = {}
    if rank == 0:
        (loss, _, grads), n1 = _launches(
            lambda: grads_of(state["params"], batch_t))
        ref.update(loss=float(loss), grads=_to_host(grads), launches=n1)
        del grads
        torch.cuda.empty_cache()
        if step:                       # the update on the CPU, 16 threads
            threads = torch.get_num_threads()
            torch.set_num_threads(16)
            old = _to_host(state["params"])
            new_p, new_opt, metrics = apply_updates(
                old, ref["grads"], _to_host(state["opt"]), ocfg)
            torch.set_num_threads(threads)
            ref.update(step_loss=ref["loss"], lr=float(metrics["lr"]),
                       new={"params": new_p, "opt": new_opt}, old=old)
    dist.barrier()
    mesh, ctx = W._context(model, "cuda")
    errs = {}
    with ctx:
        _, specs = SP.state_shapes_and_specs(cfg, dims, "train", None,
                                             opt_cfg=ocfg)
        st = distribute(state, SP.to_shardings(mesh, specs))
        del state
        bt = distribute(batch_t, SP.to_shardings(
            mesh, SP.batch_spec_axes(cfg, batch_t)))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (loss4, _, g4), n4 = _launches(lambda: grads_of(st["params"], bt))
        placements = {p: W.canon(g.placements) for p, g in
                      zip(flat_paths(g4), tree_leaves(g4))}
        same = all(W.canon(g.placements) == W.canon(p.placements) for g, p in
                   zip(tree_leaves(g4), tree_leaves(st["params"])))
        loss4 = float(full(loss4))
        if rank == 0:
            errs["loss"] = _held(torch.tensor(loss4), torch.tensor(
                ref["loss"]), "loss")
        _hold_tree(g4, ref.get("grads"), "grad", rank == 0, errs)
        del g4
        if step:
            new4, m4 = train(st, bt)
            step_loss4 = float(full(m4["loss"]))
            if rank == 0:
                errs["step_loss"] = _held(torch.tensor(step_loss4),
                                          torch.tensor(ref["step_loss"]),
                                          "step loss")
            _hold_tree(new4["opt"]["m"], ref.get("new", {}).get("opt",
                       {}).get("m"), "m", rank == 0, errs)
            _hold_tree(new4["opt"]["v"], ref.get("new", {}).get("opt",
                       {}).get("v"), "v", rank == 0, errs)
            ms, olds = ({}, {}) if rank else (
                dict(zip(flat_paths(ref["new"]["opt"]["m"]),
                         tree_leaves(ref["new"]["opt"]["m"]))),
                dict(zip(flat_paths(ref["old"]), tree_leaves(ref["old"]))))
            _hold_tree(new4["params"], ref.get("new", {}).get("params"),
                       "param", rank == 0, errs,
                       bar=lambda path, w: param_bar(
                           ms[path].to(w.device), w, olds[path], ref["lr"]))
        peak = torch.cuda.max_memory_allocated() / 2**30
    return {"errs": errs if rank == 0 else None,
            "launches": n4, "one_card_launches": ref.get("launches"),
            "placements_match": same, "placements": placements,
            "peak_gib": peak, "mesh": list(mesh.shape)}


def prefill_worker(rank, *, arch, model, batch=(4, 512)):
    """`prefill` on one card (rank 0) and sharded; rank 0's errors and
    every rank's launches."""
    import torch.distributed as dist

    from repro_torch.common.config import get_arch
    from repro_torch.launch import specs as SP
    from repro_torch.models.api import get_model
    from repro_torch.models.dims import make_dims
    from repro_torch.parallel.sharding import distribute
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch)
    mod = get_model(cfg)
    dims = make_dims(cfg, tp=model, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    params = mod.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      dims, "cuda")
    pb = {k: torch.as_tensor(v, device="cuda")
          for k, v in W._batch(cfg, *batch).items() if k != "labels"}
    ref = {}
    if rank == 0:
        (logits, state), n1 = _launches(lambda: mod.prefill(params, pb, cfg,
                                                            dims))
        ref.update(logits=logits, state=state, launches=n1)
    dist.barrier()
    mesh, ctx = W._context(model, "cuda")
    errs = {}
    with ctx:
        _, psp = SP.state_shapes_and_specs(cfg, dims, "prefill", None)
        p4 = distribute(params, SP.to_shardings(mesh, psp))
        b4 = distribute(pb, SP.to_shardings(mesh, SP.batch_spec_axes(cfg,
                                                                     pb)))
        (logits4, state4), n4 = _launches(lambda: mod.prefill(p4, b4, cfg,
                                                              dims))
        v = cfg.vocab_size                 # the padded columns are -inf
        _hold_tree({"logits": logits4[:, :v]}, {"logits": ref["logits"][
            :, :v]} if rank == 0 else None, "prefill", rank == 0, errs)
        _hold_tree(state4, ref.get("state"), "state", rank == 0, errs)
    return {"errs": errs if rank == 0 else None, "launches": n4,
            "one_card_launches": ref.get("launches")}


def restore_worker(rank, *, ckpt_dir, model=2):
    """Rank 0 saves a qwen2-0.5b train state from its card alone; every
    rank restores it sharded and checks its local shards; rank 0 checks
    every full tensor against the saved leaf."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointConfig, CheckpointEngine
    from repro_torch.common.config import get_arch
    from repro_torch.common.treeutil import tree_leaves
    from repro_torch.launch import specs as SP
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.parallel.sharding import full
    from repro_torch.train.step import make_state
    cfg = get_arch("qwen2-0.5b")
    dims = make_dims(cfg, tp=model, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig(factored_v=True)
    eng_cfg = CheckpointConfig(directory=ckpt_dir, interval=1, n_banks=4)
    if rank == 0:
        state = make_state(torch.Generator(device="cuda").manual_seed(7),
                           cfg, dims, ocfg, device="cuda")
        eng = CheckpointEngine(eng_cfg)
        eng.force_snapshot(3, state)
        eng.flush_all_now()
        eng.wait()
        del state
    dist.barrier()
    saved = {}
    ep = os.path.join(ckpt_dir, "step_00000003")
    for b in range(4):
        with np.load(os.path.join(ep, f"bank_{b}.npz")) as z:
            saved.update({int(k): z[k] for k in z.files})
    mesh, ctx = W._context(model, "cuda")
    bad, sharded, whole_equal = [], 0, True
    with ctx:
        template = make_state(torch.Generator(device="cuda"), cfg, dims,
                              ocfg, device="cuda")
        _, specs = SP.state_shapes_and_specs(cfg, dims, "train", None,
                                             opt_cfg=ocfg)
        state, step = CheckpointEngine(eng_cfg).restore(
            template, shardings=SP.to_shardings(mesh, specs))
        coord, shape = list(mesh.get_coordinate()), list(mesh.shape)
        for i, x in enumerate(tree_leaves(state)):
            pl = W.canon(x.placements)
            sharded += any(p.startswith("S") for p in pl)
            want = W.expected_local(saved[i], pl, coord, shape)
            if not np.array_equal(x.to_local().cpu().numpy(), want):
                bad.append(i)
            whole = full(x)
            if rank == 0 and not np.array_equal(whole.cpu().numpy(),
                                                 saved[i]):
                whole_equal = False
    return {"step": step, "bad_local": bad, "sharded_leaves": sharded,
            "whole_equal": whole_equal, "leaves": len(saved)}


@pytest.mark.parametrize("model", [2, 4], ids=lambda m: f"model{m}")
def test_qwen25_3b_sharded_step_matches_one_card(model):
    _cards()
    out = W.run_ranks(dense_worker, CARDS, backend="nccl", timeout=TIMEOUT,
                      arch="qwen2.5-3b", model=model)
    assert out[0]["errs"]["loss"] >= 0.0
    for r in out:
        assert r["placements_match"]
        assert r["launches"]["flash_attention"] == out[0][
            "one_card_launches"]["flash_attention"] > 0
    _report("qwen2.5-3b step", out, mesh=out[0]["mesh"])


def test_moe_sharded_gradients_match_one_card():
    _cards()
    out = W.run_ranks(dense_worker, CARDS, backend="nccl", timeout=TIMEOUT,
                      arch="qwen3-moe-235b-a22b", model=4, layers=2,
                      step=False)
    assert out[0]["errs"]["loss"] >= 0.0
    for r in out:
        assert r["placements_match"]
        assert r["launches"]["flash_attention"] == out[0][
            "one_card_launches"]["flash_attention"] > 0
    _report("qwen3-moe 2 layers gradients", out, mesh=out[0]["mesh"])


@pytest.mark.parametrize("model", [2, 4], ids=lambda m: f"model{m}")
def test_mamba2_prefill_on_local_ssd_heads_matches_one_card(model):
    _cards()
    out = W.run_ranks(prefill_worker, CARDS, backend="nccl",
                      timeout=TIMEOUT, arch="mamba2-130m", model=model)
    n_layers = 24
    assert out[0]["one_card_launches"]["mamba2_ssd"] == n_layers
    for r in out:
        assert r["launches"]["mamba2_ssd"] == n_layers
    assert out[0]["errs"]
    _report("mamba2-130m prefill", out, model=model)


def test_one_card_checkpoint_restores_sharded_on_four(tmp_path):
    _cards()
    out = W.run_ranks(restore_worker, CARDS, backend="nccl",
                      timeout=TIMEOUT, ckpt_dir=str(tmp_path / "ckpt"))
    for r in out:
        assert r["step"] == 3
        assert r["bad_local"] == []
        assert r["sharded_leaves"] > 0
    assert out[0]["whole_equal"]
    print(json.dumps({"test": "restore", "leaves": out[0]["leaves"],
                      "sharded_leaves_by_card": [r["sharded_leaves"]
                                                 for r in out]}),
          flush=True)


def test_fake_world_counts_what_nccl_runs():
    _cards()
    fake = W.run_alone(W.count_step_worker, model=2, device="cuda",
                       fake=True)
    (real,) = W.run_ranks(W.count_step_worker, CARDS, backend="nccl",
                          timeout=TIMEOUT, model=2, device="cuda")[:1]
    assert (fake["backend"], real["backend"]) == ("fake", "nccl")
    assert fake["counts"].get("all-gather", 0) > 0
    for field in ("counts", "wire", "wire_bytes", "links", "link_wire"):
        assert fake[field] == real[field], field
    print(json.dumps({"test": "fake world vs nccl", "counts": real["counts"],
                      "wire_bytes": real["wire_bytes"]}), flush=True)
