"""The benchmark's frozen references and counts against the port, at
sizes the CPU holds: the closed DRAM model and its demands, the tick
loop's operation count, Qwen2's loss and AdamW. The port is the program;
these tests show that the reference the cells are judged by computes
what the program should."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.counts import model_flops, sweep_ops
from perfbench.reference import adamw, qwen2, sweep_check
from perfbench.traffic import sweep_grid, weights

HERE = Path(__file__).resolve().parent

DRAM = {"n_banks": 8, "n_subarrays": 8, "n_ranks": 1, "n_channels": 1,
        "dt_ns": 6.0, "wbuf_cap": 64, "wbuf_hi": 48, "wbuf_lo": 16}
POLICIES = ("ref_ab", "darp", "dsarp", "hira", "elastic", "staggered_ab")
TINY = {"num_hidden_layers": 2, "hidden_size": 64, "intermediate_size": 128,
        "vocab_size": 256, "num_attention_heads": 4,
        "num_key_value_heads": 1, "head_dim": 16, "rms_norm_eps": 1e-6,
        "rope_theta": 1e6, "z_loss": 1e-4}


@pytest.fixture(scope="module")
def tiny_sweep():
    from repro_torch.core.sweep import SweepSpec, sweep
    spec = SweepSpec(policies=POLICIES,
                     scenarios=("closed_mixed", "closed_write_heavy"),
                     densities=(8, 32), reqs=120, seed=2 ** 31 - 7,
                     mode="closed")
    return spec, sweep(spec, backend="mega", device="cpu")


def test_dram_reference_equals_the_port(tiny_sweep):
    spec, res = tiny_sweep
    samples = [(c, c.scenario, spec.seed, spec.reqs, None) for c in res.cells]
    out = sweep_check.compare(DRAM, samples)
    assert out["cells"] == len(res.cells) == 24
    assert out["cells_differ"] == 0, out["first"]


def test_dram_control_fails(tiny_sweep):
    spec, res = tiny_sweep
    samples = [(c, c.scenario, spec.seed, spec.reqs, None) for c in res.cells]
    assert sweep_check.compare(DRAM, samples, drop_last=True)[
        "cells_differ"] == len(samples)


@pytest.mark.parametrize("name", ["closed_mixed", "closed_read_heavy",
                                  "closed_write_heavy", "closed_streaming",
                                  "closed_low_mlp"])
def test_demand_reference_equals_the_port(name):
    from repro_torch.core.refresh.scenarios import make_closed_demand
    for seed in (0, 2 ** 31 - 1, 123456789):
        d = make_closed_demand(name, 8, 8, 32, seed, 6.0)
        planes = {k: getattr(d, k) for k in sweep_check.DEMAND_PLANES}
        assert not sweep_check.demand_differs(planes, DRAM, name, seed, 32)
        planes["think"] = planes["think"] + 1
        assert sweep_check.demand_differs(planes, DRAM, name, seed, 32)


@pytest.fixture(scope="module")
def table1():
    """The configuration's system (8 cores; 2 channels x 2 ranks x 8
    banks) over every registry policy, long enough for REF_ab to fall
    due, with the presets registered as its closed scenarios on both
    sides."""
    from repro_torch.core.refresh.scenarios import register_closed_scenario
    from repro_torch.core.refresh.workload import make_workload
    from repro_torch.core.sweep import SweepSpec, sweep
    dram = json.loads((HERE / "configs" / "dram-closed-8b8s.json")
                      .read_text())["system"]
    tr = {"presets": ["low_mlp"]}
    sweep_grid.register(register_closed_scenario, make_workload, tr,
                        dram["n_cores"])
    sweep_check.register(tr, dram["n_cores"])
    spec = SweepSpec(policies=tuple(dram["policies"]),
                     scenarios=tuple(sweep_grid.scenario_names(
                         tr, dram["n_cores"])),
                     densities=(8, 32), reqs=1500, seed=2 ** 31 + 11,
                     n_banks=dram["n_banks"],
                     n_subarrays=dram["n_subarrays"],
                     n_ranks=dram["n_ranks"], n_channels=dram["n_channels"],
                     wbuf_hi=dram["wbuf_hi"], wbuf_lo=dram["wbuf_lo"],
                     wbuf_cap=dram["wbuf_cap"], dt_ns=dram["dt_ns"],
                     mode="closed")
    return dram, spec, sweep(spec, backend="mega", device="cpu")


def test_dram_reference_equals_the_port_on_the_configured_system(table1):
    dram, spec, res = table1
    assert {c.policy for c in res.cells if c.refreshes_ab} >= {"ref_ab",
                                                               "all_bank"}
    samples = [(c, c.scenario, spec.seed, spec.reqs, None) for c in res.cells]
    out = sweep_check.compare(dram, samples)
    assert out["cells"] == 28 and out["cells_differ"] == 0, out["first"]


@pytest.mark.parametrize("preset", ["mixed", "read_heavy", "write_heavy",
                                    "streaming", "low_mlp"])
def test_configured_demand_equals_the_ports(preset):
    from repro_torch.core.refresh.scenarios import (make_closed_demand,
                                                    register_closed_scenario)
    from repro_torch.core.refresh.workload import make_workload
    dram = json.loads((HERE / "configs" / "dram-closed-8b8s.json")
                      .read_text())["system"]
    tr = {"presets": [preset]}
    sweep_grid.register(register_closed_scenario, make_workload, tr, 8)
    sweep_check.register(tr, 8)
    name = sweep_grid.scenario_name(preset, 8)
    d = make_closed_demand(name, 32, 8, 80, 2 ** 31 + 3, 6.0)
    assert d.bank.shape == (8, 10) and d.bank.max() >= 8
    planes = {k: getattr(d, k) for k in sweep_check.DEMAND_PLANES}
    assert not sweep_check.demand_differs(planes, dram, name, 2 ** 31 + 3, 80)
    planes["bank"] = (planes["bank"] + 1) % 32
    assert sweep_check.demand_differs(planes, dram, name, 2 ** 31 + 3, 80)


@pytest.mark.parametrize("which", ["tiny_sweep", "table1"])
def test_closed_operations_equal_the_ports(which, request):
    from repro_torch.core.sweep.engine import _Grid
    from repro_torch.kernels import sweep_megakernel as mk
    spec = request.getfixturevalue(which)[-2]
    grid = _Grid(spec, stack_streams=False)
    cfg, order, params, _ = mk.host_inputs(grid)
    G = grid.G
    rng = np.random.default_rng(3)
    cols = {k: rng.integers(0, 50, G) for k in
            ("reads", "writes", "refpb", "refab", "ticks")}
    cols["finished"] = rng.integers(0, 2, G)
    stats = np.zeros((G, mk.MEGA_NSTAT), np.int64)
    for k, c in (("reads", mk.MS_READS), ("writes", mk.MS_WRITES),
                 ("refpb", mk.MS_REFPB), ("refab", mk.MS_REFAB),
                 ("finished", mk.MS_FINISHED)):
        stats[:, c] = cols[k][order]
    theirs = mk.closed_operations(cfg, torch.from_numpy(params.astype(
        np.int64)), torch.from_numpy(stats),
        torch.from_numpy(cols["ticks"][order]))
    mine = sweep_ops.closed_operations(
        {k: getattr(grid, k) for k in ("B", "S", "C", "K", "R", "NC", "NB")},
        grid.kind, grid.level_ab, **cols)
    assert mine == theirs > 0


def test_sweep_plans_repeat_and_differ():
    t = {"presets": ["mixed", "streaming"], "demands": 6}
    a, b = sweep_grid.plan(t, 8, 2 ** 33, 1), sweep_grid.plan(t, 8, 2 ** 33, 1)
    assert a == b and a.made
    assert a.demands != sweep_grid.plan(t, 8, 2 ** 33, 2).demands
    assert all(0 <= s < 2 ** 31 for _, s in a.demands)
    assert [n for n, _ in a.demands[:2]] == ["closed_mixed_8c",
                                             "closed_streaming_8c"]
    names = sweep_grid.plan({"presets": ["mixed"], "demands": None}, 8, 5, 0)
    assert not names.made and names.demands[0][1] == names.spec_seed


def tiny_arch():
    from repro_torch.common.config import get_arch
    return get_arch("qwen2-0.5b").reduced()


def test_qwen2_loss_equals_the_ports():
    from repro_torch.models.dims import make_dims
    from repro_torch.models.transformer import train_loss
    arch = tiny_arch()
    dims = make_dims(arch, tp=1, compute_dtype=torch.float32,
                     param_dtype=torch.float32)
    flat = weights.make(TINY, 7, "cpu")
    tok = torch.randint(0, 256, (1, 33), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    theirs, _ = train_loss(weights.program_params(flat), batch, arch, dims)
    mine = qwen2.loss(flat, batch["tokens"][0], batch["labels"][0], TINY)
    assert abs(float(mine) - float(theirs)) < 1e-5 * abs(float(theirs))


def test_adamw_equals_the_ports():
    from repro_torch.optim import OptConfig, apply_updates, init_opt
    g = torch.Generator().manual_seed(4)
    p = {"w": torch.randn(2, 5, 3, generator=g), "b": torch.randn(3, generator=g)}
    o = {"lr": 3e-4, "warmup_steps": 100, "total_steps": 10000,
         "min_lr_ratio": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
         "weight_decay": 0.1, "grad_clip": 1.0}
    cfg = OptConfig(**o)
    theirs, st = dict(p), init_opt(p, cfg)
    mine = {k: v.clone() for k, v in p.items()}
    ref = {"step": 0, "m": {}, "v": {}}
    for i in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
        theirs, st, _ = apply_updates(theirs, grads, st, cfg)
        adamw.step(mine, grads, ref, o)
    for k in p:
        torch.testing.assert_close(mine[k], theirs[k], rtol=1e-6, atol=1e-9)


def test_model_counts():
    fl = model_flops.forward_flops(TINY, 10, 55, 1)
    assert fl == (2 * model_flops.layer_matmul_params(TINY) * 10
                  + 2 * 64 * 256 + 4 * 2 * 4 * 16 * 55)
    assert model_flops.flash_flops(40, 4096, 128) == 171840634880
    assert (model_flops.train_step_flops(TINY, 2, 8)
            == 3 * model_flops.forward_flops(TINY, 16, 72, 16))
