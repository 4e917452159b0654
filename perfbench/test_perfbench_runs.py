"""Whole runs of each cell's runner, on the CPU at a small size, with the
look for a card skipped: a sound program reads `correct`, and the timed
path broken underneath reads not correct, once for each fault the cell
can have: an answer or a demand altered where it is produced; a training
step that returns its state unchanged; half of the batch left out, the
mean taken over the rest. (No cell spans chips, so none can leave out
an exchange between them.) `run.py` itself refuses to run without a
card, or without the program beside it, and prints no result.

The controls are read on the card (`control.py`, `test_controls_on_card`):
TF32 products cannot be had on the CPU."""
import argparse
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import faults, harness, model

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TINY = {"num_hidden_layers": 2, "hidden_size": 64, "intermediate_size": 128,
        "vocab_size": 256, "num_attention_heads": 4,
        "num_key_value_heads": 1, "head_dim": 16}


def cpu_run(cell: str, seconds: float = 0.5, seed: int = 3_000_000_017,
            edit=None, control: bool = False):
    """A run of `cell`'s runner on the CPU at a small size; `edit(runner,
    run)` may break the program under it first."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    w = harness.load_json(HERE / "workloads" / f"{cell}.json")
    name = w["config"]
    cfg = harness.load_json(HERE / "configs" / f"{name}.json")
    t = w["traffic"]
    if w["runner"] == "sweep":
        t.update(demands=6 if t["demands"] else None, reqs=min(t["reqs"], 60),
                 policies=t["policies"][:3], sample_per_sweep=4,
                 check_cells=12)
    else:
        cfg["model"].update(TINY)
        t.update(seq_len=32, vocab=256)
    ns = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
    r = harness.Run(ns, time.perf_counter(), bench, {"name": cell}, w, cfg)
    r.device, r.control = "cpu", control
    runner = harness.load_module(HERE / "runners" / f"{w['runner']}.py",
                                 f"cpu_runner_{w['runner']}")
    if edit is not None:
        edit(runner, r)
    return runner.run(r), r


@pytest.fixture
def tiny_arch(monkeypatch):
    from repro_torch.common.config import get_arch
    monkeypatch.setattr(model, "program_arch",
                        lambda c: get_arch(c["program_arch"]).reduced())
    torch.set_num_threads(2)


def correct(out) -> bool:
    return all(c.ok for c in out["checks"])


# --------------------------------------------------------------- sweeps
@pytest.mark.parametrize("cell", ["dram-closed-8b8s.ladder_1e4",
                                  "dram-closed-8b8s.paper_grid"])
def test_sweep_run_is_correct(cell):
    out, r = cpu_run(cell, control=True)
    assert correct(out), [(c.name, c.value) for c in out["checks"]]
    assert out["attempted"] > 0 and out["end_to_end"]["sweep_cells_per_s"] > 0
    assert r.counters["compare"]["cells"] > 0
    assert r.counters["control"]["cells_differ"] > 0


@pytest.mark.parametrize("cell", ["dram-closed-8b8s.ladder_1e4",
                                  "dram-closed-8b8s.paper_grid"])
def test_sweep_answer_altered_is_caught(cell, monkeypatch):
    from repro_torch.kernels import sweep_megakernel as mk
    orig = mk.run_mega

    def altered(grid, **kw):
        out = orig(grid, **kw)
        out["lat_sum"] = out["lat_sum"] + 6
        return out

    out, _ = cpu_run(cell, edit=lambda runner, r:
                     monkeypatch.setattr(mk, "run_mega", altered))
    assert not correct(out)


def test_sweep_demand_altered_is_caught(monkeypatch):
    from repro_torch.core.refresh import scenarios
    orig = scenarios.make_closed_demand

    def altered(*a, **kw):
        d = orig(*a, **kw)
        d.think[0, 0] += 1
        return d

    monkeypatch.setattr(scenarios, "make_closed_demand", altered)
    out, _ = cpu_run("dram-closed-8b8s.ladder_1e4")
    assert {c.name for c in out["checks"] if not c.ok} >= {"demands_differ"}


# ------------------------------------------------------------- training
def test_train_run_is_correct(tiny_arch):
    out, r = cpu_run("qwen2-0.5b.train_4k")
    assert correct(out), r.counters["readings"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_train_fault_is_caught(kind, tiny_arch):
    out, r = cpu_run("qwen2-0.5b.train_4k", edit=faults.edit(kind))
    assert not correct(out), r.counters["readings"]


# ------------------------------------------------------------- run.py
def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "dram-closed-8b8s.paper_grid", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "cuda" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path),
               PYTHONPATH="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "dram-closed-8b8s.paper_grid", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_breakdown_names_idle_time_by_innermost_span():
    k = [("a", 1.0, 1.5), ("b", 3.0, 3.2)]
    spans = [("sweep", 0.5, 4.0), ("grid", 0.5, 1.2), ("finalize", 1.6, 2.5)]
    busy = harness.busy_intervals(k, 0.0, 4.0)
    out = harness.breakdown(k, busy, spans, 0.0, 4.0)
    idle = dict(out["idle_gaps"])
    assert idle["finalize"] == pytest.approx(0.9)
    assert idle["outside any span"] == pytest.approx(0.5)
    assert sum(idle.values()) == pytest.approx(4.0 - 0.7)
    assert out["device_ops"][0] == ["a", 0.5]


# -------------------------------------------------------------- on card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the controls run TF32 products")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["qwen2-0.5b.train_4k"])
def test_controls_on_card(cell, card, tiny_arch):
    """At a small size on the card, the program reads within its limits
    and the control (the reference with TF32 products) does not read
    less than the program."""
    out, r = cpu_run(cell, control=True,
                     edit=lambda runner, run: setattr(run, "device", "cuda"))
    assert correct(out)
    ctl = r.counters["control"]
    prog = {c.name: c.value for c in out["checks"]}
    assert any(ctl[k] >= prog[k] for k in prog if k in ctl)
