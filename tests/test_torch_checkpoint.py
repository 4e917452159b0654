"""The port's checkpoint engine and trainer (`repro_torch.checkpoint`,
`repro_torch.train.Trainer`, `launch.train`, `bench_darp_ckpt`, the
quickstart) on the CPU: the reference's six trainer tests
(`tests/test_checkpoint_trainer.py`) on the port, flush scheduling step
for step equal to the reference's trainer, and checkpoints crossing
between the packages.

Bars: none where the result is an integer or bytes (flush picks, flush
and forced counts, checkpoint leaves: equal, bit for bit); resume
equivalence at the reference's own 1e-6 (the same float32 steps taken
twice, on the CPU bit-identical in practice). The trainers of the two
packages draw different weights (JAX and torch generators), which no
scheduling field depends on: DARP decides flushes from steps and bank
state, never from values.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JCkptConfig
from repro.checkpoint import CheckpointEngine as JEngine
from repro.common.config import get_arch as jget_arch
from repro.models.dims import make_dims as jmake_dims
from repro.optim import OptConfig as JOpt
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import make_state as jmake_state
from repro.train import make_train_step as jmake_step
from repro_torch.checkpoint import (CheckpointConfig, CheckpointEngine,
                                    latest_step)
from repro_torch.common.config import get_arch
from repro_torch.common.treeutil import flat_paths, tree_leaves, tree_map
from repro_torch.core.scheduler import SchedulerPolicy
from repro_torch.data import SyntheticLMData
from repro_torch.models.convert import state_from_numpy
from repro_torch.models.dims import make_dims
from repro_torch.optim import OptConfig
from repro_torch.train import Trainer, TrainerConfig, make_state, \
    make_train_step

from _torch_train_parity import one_torch_thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def _reduced(name="qwen2-0.5b"):
    cfg = get_arch(name).reduced()
    return cfg, make_dims(cfg, tp=1, param_dtype=torch.float32,
                          compute_dtype=torch.float32)


@pytest.fixture()
def setup(tmp_path):
    """The reference's fixture on the port, on the CPU."""
    cfg, dims = _reduced()
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    state = make_state(torch.Generator().manual_seed(0), cfg, dims, ocfg,
                       device="cpu")
    step_fn = make_train_step(cfg, dims, ocfg, device="cpu")
    data = SyntheticLMData(cfg.vocab_size, batch=4, seq=16, seed=0)
    return cfg, dims, ocfg, state, step_fn, data, str(tmp_path)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


# ================================== the reference's six trainer tests
def test_checkpoint_roundtrip_bitexact(setup):
    cfg, dims, ocfg, state, step_fn, data, d = setup
    eng = CheckpointEngine(CheckpointConfig(directory=d, interval=1,
                                            n_banks=3))
    eng.force_snapshot(0, state)
    eng.flush_all_now()
    eng.wait()
    restored, step = eng.restore(state)
    assert step == 0
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_partial_write_is_invisible(setup):
    cfg, dims, ocfg, state, step_fn, data, d = setup
    eng = CheckpointEngine(CheckpointConfig(directory=d, interval=1,
                                            n_banks=4))
    eng.force_snapshot(0, state)
    eng.flush_all_now()
    eng.wait()
    eng.force_snapshot(10, state)
    eng.flush_all_now()
    eng.wait()
    # simulate a crash that corrupted epoch 10: remove its manifest
    os.remove(os.path.join(d, "step_00000010", "manifest.json"))
    assert latest_step(d) == 0  # falls back to the previous complete epoch


def test_resume_equivalence(setup):
    """10 straight steps == 5 steps + checkpoint + restore + 5 steps."""
    cfg, dims, ocfg, state, step_fn, data, d = setup
    s_straight = state
    for i in range(10):
        s_straight, _ = step_fn(s_straight, data.batch_at(i))
    eng = CheckpointEngine(CheckpointConfig(directory=d, interval=1,
                                            n_banks=2))
    s_a = state
    for i in range(5):
        s_a, _ = step_fn(s_a, data.batch_at(i))
    eng.force_snapshot(4, s_a)
    eng.flush_all_now()
    eng.wait()
    s_b, step = eng.restore(state)
    assert step == 4
    for i in range(5, 10):
        s_b, _ = step_fn(s_b, data.batch_at(i))
    for a, b in zip(tree_leaves(s_straight), tree_leaves(s_b)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-6, rtol=1e-6)


def test_preemption_pull_in(setup):
    cfg, dims, ocfg, state, step_fn, data, d = setup
    ck = CheckpointConfig(directory=d, interval=50, n_banks=2)
    tr = Trainer(TrainerConfig(total_steps=40, ckpt=ck), step_fn, state,
                 iter(data), device="cpu")
    tr.preempt()  # preempt before step 0 completes
    out = tr.run()
    assert out["preempted"] is True
    # the pull-in path must have produced a complete restorable checkpoint
    assert latest_step(d) is not None


def test_darp_spreads_flushes(setup):
    """DARP flushing: banks flush across different steps (write windows),
    not all at the epoch boundary."""
    cfg, dims, ocfg, state, step_fn, data, d = setup
    ck = CheckpointConfig(directory=d, interval=8, n_banks=4,
                          policy=SchedulerPolicy.DARP)
    tr = Trainer(TrainerConfig(total_steps=30, ckpt=ck), step_fn, state,
                 iter(data), device="cpu")
    tr.run()
    st = tr.engine.stats
    assert st["epochs"] >= 3
    assert st["flushes"] >= 3 * 4
    assert st["forced"] <= st["flushes"] // 2  # mostly scheduled, not forced


def test_loss_decreases(setup):
    cfg, dims, ocfg, state, step_fn, data, d = setup
    tr = Trainer(TrainerConfig(total_steps=30, log_every=5), step_fn, state,
                 iter(data), device="cpu")
    tr.run()
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]


# ================================== scheduling, step for step
def _record_picks(engine):
    """Wrap `engine.write_window` to record (step, picks) of each call."""
    log, real = [], engine.write_window

    def window(step, *a, **kw):
        picks = real(step, *a, **kw)
        log.append((step, list(picks)))
        return picks
    engine.write_window = window
    return log


@pytest.mark.parametrize("policy,interval,n_banks,steps", [
    ("darp", 8, 4, 22), ("all_bank", 6, 3, 14), ("darp", 3, 8, 10)])
def test_flush_scheduling_equals_reference_trainer(tmp_path, policy,
                                                   interval, n_banks, steps):
    """The port's trainer and the reference's on the same data flush the
    same banks at the same steps, with the same `flushes`/`forced`/
    `epochs` counts, and leave the same complete epochs on disk."""
    cfg, dims = _reduced()
    jcfg = jget_arch("qwen2-0.5b").reduced()
    jdims = jmake_dims(jcfg, tp=1, param_dtype=jnp.float32,
                       compute_dtype=jnp.float32)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    data = SyntheticLMData(cfg.vocab_size, batch=2, seq=8, seed=0)
    runs = {}
    for side in ("port", "reference"):
        d = str(tmp_path / side)
        if side == "port":
            ck = CheckpointConfig(directory=d, interval=interval,
                                  n_banks=n_banks, policy=policy)
            tr = Trainer(TrainerConfig(total_steps=steps, ckpt=ck),
                         make_train_step(cfg, dims, OptConfig(**kw),
                                         device="cpu"),
                         make_state(torch.Generator().manual_seed(0), cfg,
                                    dims, OptConfig(**kw), device="cpu"),
                         iter(data), device="cpu")
        else:
            ck = JCkptConfig(directory=d, interval=interval,
                             n_banks=n_banks, policy=policy)
            tr = JTrainer(JTrainerConfig(total_steps=steps, ckpt=ck),
                          jmake_step(jcfg, jdims, JOpt(**kw)),
                          jmake_state(jax.random.PRNGKey(0), jcfg, jdims,
                                      JOpt(**kw)), iter(data))
        log = _record_picks(tr.engine)
        tr.run()
        stats = {k: tr.engine.stats[k] for k in ("epochs", "flushes",
                                                 "forced")}
        runs[side] = (log, stats, sorted(os.listdir(d)))
    assert runs["port"] == runs["reference"]
    assert runs["port"][1]["flushes"] > 0


def test_bench_darp_ckpt_flushes_equal_reference_artifact():
    """`bench_darp_ckpt` at `run.py --fast`'s 20 steps, on the CPU: its
    `flushes` equal the reference's `results/bench/darp_ckpt.json`
    (24 / 24 / 0); the other fields are wall clock."""
    import sys
    sys.path.insert(0, ROOT)
    from benchmarks_torch import bench_framework as BF
    with open(os.path.join(ROOT, "results", "bench", "darp_ckpt.json")) as f:
        want = json.load(f)
    got = BF.bench_darp_ckpt(steps=20, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert set(got[k]) == set(want[k]), k
        assert got[k]["flushes"] == want[k]["flushes"], k


# ================================== across the packages
def _jstate(moment_dtype="float32", factored_v=False):
    jcfg = jget_arch("qwen2-0.5b").reduced()
    jdims = jmake_dims(jcfg, tp=1, param_dtype=jnp.float32,
                       compute_dtype=jnp.float32)
    js = jmake_state(jax.random.PRNGKey(0), jcfg, jdims,
                     JOpt(moment_dtype=moment_dtype, factored_v=factored_v))
    # moments away from zero, so that their bits say something
    js["opt"] = jax.tree.map(lambda x: x + jnp.asarray(0.37, x.dtype)
                             if jnp.issubdtype(x.dtype, jnp.floating) else
                             x + 3, js["opt"])
    return js


def _write(engine_cls, cfg_cls, d, state, step=6):
    eng = engine_cls(cfg_cls(directory=d, interval=1, n_banks=3))
    eng.force_snapshot(step, state)
    eng.flush_all_now()
    eng.wait()
    return eng


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """Written by the reference, restored by the port into its converted
    template: f32 and int32 leaves bit-exact, the same manifest paths."""
    js = _jstate(factored_v=True)
    _write(JEngine, JCkptConfig, str(tmp_path), js)
    template = tree_map(torch.zeros_like,
                        state_from_numpy(jax.device_get(js), "cpu"))
    restored, step = CheckpointEngine(CheckpointConfig(
        directory=str(tmp_path), n_banks=3)).restore(template)
    assert step == 6
    want = state_from_numpy(jax.device_get(js), "cpu")
    for a, b in zip(tree_leaves(restored), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(tmp_path / "step_00000006" / "manifest.json") as f:
        assert json.load(f)["paths"] == flat_paths(want)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """Written by the port, restored by the reference: every leaf
    bit-exact; the files (leaf keys, crc32s, manifest) are the ones the
    reference writes for the same state."""
    js = _jstate(factored_v=True)
    ts = state_from_numpy(jax.device_get(js), "cpu")
    _write(CheckpointEngine, CheckpointConfig, str(tmp_path / "port"), ts)
    _write(JEngine, JCkptConfig, str(tmp_path / "ref"), js)
    restored, step = JEngine(JCkptConfig(directory=str(tmp_path / "port"),
                                         n_banks=3)).restore(js)
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for b in range(3):
        for name in (f"bank_{b}.crc.json",):
            got = json.load(open(tmp_path / "port" / "step_00000006" / name))
            want = json.load(open(tmp_path / "ref" / "step_00000006" / name))
            assert got == want
    got = json.load(open(tmp_path / "port" / "step_00000006" /
                         "manifest.json"))
    want = json.load(open(tmp_path / "ref" / "step_00000006" /
                          "manifest.json"))
    assert got == want


def test_bf16_moments_cross_as_raw_bytes_and_the_port_restores_them(
        tmp_path):
    """bf16 moments: both packages write the same `|V2` bytes (same
    crc32s); the port restores them bit for bit, from its own checkpoint
    and from the reference's."""
    js = _jstate(moment_dtype="bfloat16")
    ts = state_from_numpy(jax.device_get(js), "cpu")
    assert any(x.dtype == torch.bfloat16 for x in tree_leaves(ts))
    _write(CheckpointEngine, CheckpointConfig, str(tmp_path / "port"), ts)
    _write(JEngine, JCkptConfig, str(tmp_path / "ref"), js)
    for b in range(3):
        name = f"bank_{b}.crc.json"
        assert json.load(open(tmp_path / "port" / "step_00000006" / name)) \
            == json.load(open(tmp_path / "ref" / "step_00000006" / name))
        with np.load(tmp_path / "port" / "step_00000006" /
                     f"bank_{b}.npz") as z:
            assert all(z[k].dtype != np.uint16 for k in z.files)
    template = tree_map(torch.zeros_like, ts)
    for side in ("port", "ref"):
        restored, _ = CheckpointEngine(CheckpointConfig(
            directory=str(tmp_path / side), n_banks=3)).restore(template)
        for a, b in zip(tree_leaves(restored), tree_leaves(ts)):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_reference_restore_of_bf16_leaves_raises(tmp_path):
    """Pins the reference defect the port departs from: its `restore`
    casts a stored bf16 leaf (`|V2`) with `astype`
    (`src/repro/checkpoint/engine.py:243`), which numpy refuses."""
    js = _jstate(moment_dtype="bfloat16")
    eng = _write(JEngine, JCkptConfig, str(tmp_path), js)
    with pytest.raises((ValueError, TypeError)):
        eng.restore(js)


def test_resumed_trainer_ending_before_an_epoch_flushes_nothing(setup):
    """A trainer resumed at step 9 that stops at 12, before its next epoch
    (interval 4... 12), ends without a flush on the port; the reference's
    final `flush_all_now` flushes a bank of `None` and raises there
    (pinned here, the port's departure)."""
    cfg, dims, ocfg, state, step_fn, data, d = setup
    ck = CheckpointConfig(directory=d, interval=4, n_banks=2)
    tr = Trainer(TrainerConfig(total_steps=9, ckpt=ck), step_fn, state,
                 iter(data), device="cpu")
    tr.run()
    tr2 = Trainer(TrainerConfig(total_steps=12, ckpt=ck), step_fn, state,
                  iter(data), device="cpu")
    assert tr2.maybe_restore() and tr2.start_step == 9
    assert tr2.run()["step"] == 11
    assert tr2.engine.stats["flushes"] == 0 and latest_step(d) == 8
    jeng = JEngine(JCkptConfig(directory=d + "_ref", interval=4))
    with pytest.raises(TypeError):
        jeng.flush_all_now()


# ================================== launch, quickstart
def test_launch_train_on_the_cpu_checkpoints_and_resumes(tmp_path, capsys):
    """`python -m repro_torch.launch.train --device cpu`: trains,
    checkpoints with DARP, and a second run resumes from the newest
    complete epoch."""
    from repro_torch.launch import train as LT
    args = ["--reduced", "--steps", "9", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-interval", "4"]
    assert LT.main(args) == 0
    out = capsys.readouterr().out
    assert "device=cpu done:" in out and "ckpt stats:" in out
    assert latest_step(str(tmp_path)) == 8
    assert LT.main(args[:2] + ["12"] + args[3:]) == 0
    assert "restored from step 8" in capsys.readouterr().out


def test_quickstart_trains_resumes_and_decodes():
    """`examples/quickstart_torch.py --device cpu`: the loss falls over
    30 steps, the run resumes at step 21, 8 tokens are generated."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(ROOT, "examples",
                                         "quickstart_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out, out2, toks = mod.main(["--device", "cpu"])
    assert out["preempted"] is False and out["step"] == 29
    assert out2["step"] == 39 and out2["loss"] < out["loss"]
    assert len(toks) == 8
