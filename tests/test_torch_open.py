"""Port parity, open-loop sweeps (`SweepSpec(mode="open")`, the default):
`torchbody.open_body` against the JAX package's `jaxbody.open_body` tick
by tick on all 33 state planes, and `sweep()` of `repro_torch` on every
backend — `batched`, `scalar`, `torch` (arbiter "torch" and "cuda") and
`mega` — against the reference's `batched` and `mega` (Pallas interpret
mode off-TPU). On CPU tensors the port's kernel wrappers run their plain
PyTorch versions through the same host layout; the CUDA kernels
themselves are held against those on the card (`chip_smoke.py`,
`tests/test_torch_gpu.py`). Tolerance: none (exact equality)."""
import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.policy import list_policies
from repro.core.sweep import SweepSpec as RefSpec, sweep as ref_sweep
from repro.core.sweep import engine as ref_engine
from repro.core.sweep import jaxbody
from repro.core.sweep.arbiter import arbiter_scores
from repro.kernels import sweep_megakernel as ref_mega

from repro_torch.core.sweep import SweepSpec, sweep, torchbody
from repro_torch.core.sweep.engine import _Grid
from repro_torch.core.sweep.fields import (MEGA_NPARAM, MEGA_NSTAT,
                                           MP_KIND, MS_FINISHED, MS_P99,
                                           MS_READS, MS_REFAB, MS_REFPB,
                                           MS_WRITES)
from repro_torch.core.sweep.policies import KIND_DARP
from repro_torch.kernels import sweep_arbiter as tarb
from repro_torch.kernels import sweep_megakernel as mega

from _torch_parity import ONE_PER_KIND, assert_cells_equal, spec_kwargs

POLICIES = tuple(list_policies())
FIXTURE = (Path(__file__).resolve().parent / "fixtures" / "megakernel"
           / "case_open_mixed_density_tiles.json")


# ------------------------------------------------- tick-by-tick parity
def _np_state(s):
    return {k: np.asarray(v) for k, v in s.items()}


def _compare_planes(ref_state, port_state, ctx):
    got = torchbody.state_to_numpy(port_state)
    assert set(got) == set(ref_state) and len(got) == 33
    for k, v in ref_state.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f"{ctx} plane {k}")


@pytest.mark.parametrize("grid_name,start,ticks", [
    ("flat", 0, 80), ("flat", 1270, 60), ("multirank", 1290, 50),
    ("subarray1", 1285, 40), ("subarray4", 1280, 50)])
def test_open_body_tick_by_tick(grid_name, start, ticks):
    """Run the reference body to `start`, then for each of the next
    `ticks` ticks load the reference state into the port, advance both
    one tick and compare all 33 planes; a free run of the port's body
    over the window must end equal too. Every grid holds all registered
    policies (so `has_stag` and `has_hra`); the windows past tick ~1270
    cover all-bank refresh accrual, rank drain and staggered starts.
    "flat" is S=8, the spec's default."""
    kw = dict(policies=POLICIES, densities=(32,), reqs=1200, seed=5)
    if grid_name == "flat":
        kw.update(scenarios=("mixed", "write_burst_draining"))
    elif grid_name == "multirank":
        kw.update(scenarios=("bank_camping",), n_ranks=2, n_channels=2)
    else:
        kw.update(scenarios=("subarray_conflict_adversarial",),
                  n_subarrays=int(grid_name[-1]))
    rgrid = ref_engine._Grid(RefSpec(**kw))
    rcfg = jaxbody.open_cfg(rgrid)
    rcst = jaxbody.open_consts(rgrid)
    scores = lambda t, **p: arbiter_scores(jax.numpy, t, **p)
    step = jax.jit(functools.partial(jaxbody.open_body, rcfg, rcst, scores))
    s = jaxbody.open_state0(rcfg, rcst)
    for _ in range(start):
        s = step(s)

    grid = _Grid(SweepSpec(**kw))
    cfg = torchbody.open_cfg(grid)
    assert cfg == torchbody.TickCfg(**{
        f: getattr(rcfg, f) for f in rcfg.__dataclass_fields__})
    assert cfg.has_stag and cfg.has_hra
    cst = torchbody.consts_from_numpy(_np_state(rcst))
    own = torchbody.open_consts(grid)
    assert set(own) == set(cst)
    for k, v in cst.items():             # the port's consts match too
        if k == "horizon":
            assert own[k] == v
        else:
            assert torch.equal(own[k], v), k
    if start == 0:
        _compare_planes(_np_state(s), torchbody.open_state0(cfg, cst),
                        "state0")
    free_run = torchbody.state_from_numpy(_np_state(s))
    for i in range(ticks):
        loaded = torchbody.state_from_numpy(_np_state(s))
        assert bool(jaxbody.open_cond(rcst, s)) \
            == torchbody.open_cond(cst, loaded)
        s = step(s)
        ref_np = _np_state(s)
        _compare_planes(ref_np, torchbody.open_body(
            cfg, cst, tarb.arbiter_scores_torch, loaded),
            f"{grid_name} t={start + i} (loaded)")
        free_run = torchbody.open_body(cfg, cst, tarb.arbiter_scores_torch,
                                       free_run)
    _compare_planes(ref_np, free_run, f"{grid_name} free run")
    assert ref_np["reads"].sum() > 0 and ref_np["writes"].sum() > 0
    if start:
        assert ref_np["refab"].sum() > 0 and ref_np["refpb"].sum() > 0


# ------------------------------------------------ every backend, end to end
_BACKENDS = [("batched", {}), ("scalar", {}),
             ("torch", {"arbiter": "torch", "device": "cpu"}),
             ("torch", {"arbiter": "cuda", "device": "cpu"}),
             ("mega", {"device": "cpu"})]
_IDS = ["batched", "scalar", "torch", "torch-arbiter-cuda", "mega"]


@pytest.mark.parametrize("backend,kw", _BACKENDS, ids=_IDS)
def test_open_sweep_equals_reference_batched_and_mega(backend, kw):
    """`arbiter="cuda"` on CPU tensors exercises the kernel wrapper's
    checks and casts in its open form (no `occ`); the wrapper then takes
    the plain version."""
    spec_kw = spec_kwargs("open_kernels", None)
    port = sweep(SweepSpec(**spec_kw), backend, **kw)
    assert port.backend == backend and all(c.mode == "open"
                                           for c in port.cells)
    assert all(c.finished for c in port.cells)
    assert_cells_equal(ref_sweep(RefSpec(**spec_kw), "batched"), port,
                       f"{backend} vs ref batched")
    assert_cells_equal(ref_sweep(RefSpec(**spec_kw), "mega"), port,
                       f"{backend} vs ref mega")
    if backend == "mega":
        assert set(port.seconds) == {"grid", "run", "finalize"}


@pytest.mark.parametrize("grid", ["open_conformance", "open_multirank",
                                  "open_subarray1", "open_subarray4",
                                  "open_subarray8"])
@pytest.mark.parametrize("backend,kw", [_BACKENDS[0], _BACKENDS[4]],
                         ids=["batched", "mega"])
def test_open_grids_equal_reference_batched(grid, backend, kw):
    """All registered policies on the conformance, multirank (R=2, C=2)
    and subarray (S in {1, 4, 8}) grids in open form."""
    spec_kw = spec_kwargs(grid, POLICIES)
    port = sweep(SweepSpec(**spec_kw), backend, **kw)
    assert all(c.finished for c in port.cells)
    assert_cells_equal(ref_sweep(RefSpec(**spec_kw), "batched"), port, grid)


def test_open_golden_fixture_replays_through_the_port():
    """The reference's pinned open-loop megakernel case, read-only."""
    case = json.loads(FIXTURE.read_text())
    assert case["mode"] == "open"
    kw = dict(policies=tuple(case["policies"]),
              scenarios=tuple(case["scenarios"]),
              densities=tuple(case["densities"]), reqs=case["reqs"],
              seed=case["seed"], mode="open",
              n_ranks=case.get("n_ranks", 1),
              n_channels=case.get("n_channels", 1),
              n_subarrays=case.get("n_subarrays", 1))
    ref = ref_sweep(RefSpec(**kw), "batched")
    for backend, extra in (("mega", {"device": "cpu"}), ("batched", {}),
                           ("torch", {"device": "cpu"})):
        assert_cells_equal(ref, sweep(SweepSpec(**kw), backend, **extra),
                           f"{FIXTURE.stem}/{backend}")


@pytest.mark.parametrize("grid", ["wide_closed", "wide_open"])
def test_128_bank_grids_equal_reference(grid):
    """More than 64 global banks (16 a rank x 4 ranks x 2 channels): the
    megakernels' wrapper no longer refuses such a cell, and the plain
    path it takes on the CPU equals the reference, one policy per kind."""
    spec_kw = spec_kwargs(grid, ONE_PER_KIND)
    spec = SweepSpec(**spec_kw)
    assert spec.n_banks_total == 128
    ref = ref_sweep(RefSpec(**spec_kw), "batched")
    assert_cells_equal(ref, sweep(spec, "mega", device="cpu"), grid)
    assert_cells_equal(ref, sweep(spec, "batched"), grid)


# --------------------------------------------------- megakernel host side
def test_open_layout_and_streams_equal_reference():
    kw = spec_kwargs("open_conformance", POLICIES)
    rgrid = ref_engine._Grid(RefSpec(**kw), stack_streams=False)
    grid = _Grid(SweepSpec(**kw))
    np.testing.assert_array_equal(mega._pack_params(grid),
                                  ref_mega._pack_params(rgrid))
    rows, _, _ = ref_mega._layout(rgrid, tile=grid.G)
    np.testing.assert_array_equal(mega._layout(grid), rows[rows >= 0])
    for name in ("scn_qa", "scn_qr", "scn_qs", "scn_qw", "scn_npb",
                 "scn_of_cell", "n_per_bank", "n_tot"):
        np.testing.assert_array_equal(getattr(grid, name),
                                      getattr(rgrid, name), name)
    assert (grid.horizon, grid.L) == (rgrid.horizon, rgrid.L)
    cfg, _, _, _, streams, npb = mega.device_inputs(grid, "cpu")
    assert not cfg.closed and cfg.L == grid.L
    assert set(streams) == {"qa", "qr", "qs", "qw"}
    assert tuple(npb.shape) == (grid.scn_npb.shape[0], grid.B)


#: the dispatch tests' grid: `open_kernels` with fewer requests (each
#: launch of the plain version is a whole tick loop on the CPU)
_DISPATCH = dict(spec_kwargs("open_kernels", None), reqs=16)


@pytest.mark.parametrize("n_shards", [2, 3, 64])
def test_open_mega_shards_cover_the_grid_in_contiguous_shares(
        monkeypatch, n_shards):
    """With the device list faked (every shard on the CPU): one
    contiguous share of ``ceil(G / n_shards)`` kernel rows a shard, each
    sent only the FIFO planes its rows name, every row launched once,
    and the result equal to the one-shard run."""
    grid = _Grid(SweepSpec(**_DISPATCH))
    base = mega.run_mega(grid, device="cpu")
    assert base["core_finish"] is None and base["ticks"] is None
    G, cpu = grid.G, torch.device("cpu")
    monkeypatch.setattr(mega, "_shard_devices", lambda d, n: [cpu] * n)
    uploads, launches = [], []
    real_upload, real_cells = mega.upload, mega.mega_open_cells

    def upload(grid, params, scn, device, r0=0, r1=None):
        out = real_upload(grid, params, scn, device, r0, r1)
        uploads.append((r0, r1, out[3].shape[0], out[2]["qa"].shape[0],
                        int(out[1].min()), len(set(scn[r0:r1].tolist()))))
        return out

    def cells(cfg, params, scn, streams, npb):
        launches.append(params.shape[0])
        return real_cells(cfg, params, scn, streams, npb)

    monkeypatch.setattr(mega, "upload", upload)
    monkeypatch.setattr(mega, "mega_open_cells", cells)
    got = mega.run_mega(grid, device="cpu", n_shards=n_shards)
    assert got["core_finish"] is None and got["ticks"] is None
    per = -(-G // n_shards)
    assert [u[0] for u in uploads] == list(range(0, G, per))
    assert all(r1 - r0 == min(per, G - r0) for r0, r1, *_ in uploads)
    assert all(ns == nq == used and lo == 0
               for _, _, ns, nq, lo, used in uploads)
    assert sum(launches) == G
    assert launches == [r1 - r0 for r0, r1, *_ in uploads]
    for k in base:
        if base[k] is not None:
            np.testing.assert_array_equal(base[k], got[k], k)


@pytest.mark.parametrize("backend,kw", _BACKENDS, ids=_IDS)
def test_open_unfinished_cells_report_the_horizon(backend, kw):
    """A horizon too short to finish: every backend stops every cell at
    the grid's horizon, unfinished, exactly as the reference does."""
    spec_kw = dict(spec_kwargs("open_kernels", None), horizon=60)
    port = sweep(SweepSpec(**spec_kw), backend, **kw)
    assert not any(c.finished for c in port.cells)
    assert_cells_equal(ref_sweep(RefSpec(**spec_kw), "batched"), port,
                       f"horizon/{backend}")
    assert_cells_equal(ref_sweep(RefSpec(**spec_kw), "mega"), port,
                       f"horizon/{backend} vs ref mega")


def test_open_operations_counts_one_cell_by_hand():
    """`open_operations` on one `darp` cell, against the sum spelled out
    from its docstring."""
    grid = _Grid(SweepSpec(**spec_kwargs("open_kernels", None)))
    cfg = mega.host_inputs(grid)[0]
    B, S, R, NC = cfg.B, cfg.S, cfg.R, cfg.NC
    params = torch.zeros((1, MEGA_NPARAM), dtype=torch.int32)
    params[0, MP_KIND] = KIND_DARP
    stats = torch.zeros((1, MEGA_NSTAT), dtype=torch.int32)
    stats[0, MS_READS], stats[0, MS_WRITES] = 5, 2
    stats[0, MS_REFPB], stats[0, MS_REFAB] = 3, 0
    stats[0, MS_P99], stats[0, MS_FINISHED] = 9, 1
    ticks = torch.tensor([10], dtype=torch.int32)
    scan = 2 + 4 * B + 1 + 1 + 12 * B
    tick = (3 + 2 * B + 1 + 1 + B * (12 + 2 * S) + scan + 2 + 1 + 2 * R
            + 2 * B + 1 + NC + B)
    once = B + 3 + 2 * (9 + 1)
    assert mega.open_operations(cfg, params, stats, ticks) == (
        10 * tick + 7 * (4 + 54) + 2 + 3 * 15 + once)


# ------------------------------------------------------------- entry point
def test_record_commands_needs_closed_mode_as_in_the_reference():
    kw = spec_kwargs("open_kernels", None)
    for backend in ("batched", "mega"):
        with pytest.raises(ValueError, match="mode='closed'"):
            sweep(SweepSpec(**kw), backend, record_commands=True,
                  device="cpu")
        with pytest.raises(ValueError, match="mode='closed'"):
            ref_sweep(RefSpec(**kw), backend, record_commands=True)


def test_open_default_device_is_the_card_and_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    spec = SweepSpec(**spec_kwargs("open_kernels", None))
    assert spec.mode == "open"
    before = (mega.LAUNCHES, mega.OPEN_LAUNCHES, tarb.LAUNCHES)
    for backend, kw in (("mega", {}), ("torch", {}),
                        ("batched", {"arbiter": "cuda"}),
                        ("torch", {"arbiter": "cuda", "device": "cuda"})):
        with pytest.raises(RuntimeError, match="is_available"):
            sweep(spec, backend, **kw)
    with pytest.raises(RuntimeError, match="is_available"):
        sweep(spec)                               # default backend
    grid = _Grid(spec)
    with pytest.raises(RuntimeError, match="is_available"):
        mega.run_mega(grid)
    assert (mega.LAUNCHES, mega.OPEN_LAUNCHES, tarb.LAUNCHES) == before \
        == (0, 0, 0)


@pytest.mark.parametrize("fault", ["dtype", "shape", "stride", "banks",
                                   "mode", "streams"])
def test_open_wrapper_rejects_bad_inputs(fault):
    import dataclasses
    grid = _Grid(SweepSpec(**spec_kwargs("open_kernels", None)))
    cfg, _, params, scn, streams, npb = mega.device_inputs(grid, "cpu")
    if fault == "dtype":
        npb = npb.to(torch.int64)
    elif fault == "shape":
        scn = scn[:-1]
    elif fault == "stride":
        streams = dict(streams, qr=streams["qr"].transpose(1, 2))
    elif fault == "banks":
        cfg = dataclasses.replace(cfg, B=2 * mega.MAX_BANKS,
                                  NB=2 * mega.MAX_BANKS)
    elif fault == "mode":
        cfg = dataclasses.replace(cfg, closed=True)
    else:
        streams = {k: v for k, v in streams.items() if k != "qw"}
    with pytest.raises((TypeError, ValueError)):
        mega.mega_open_cells(cfg, params, scn, streams, npb)
    assert mega.OPEN_LAUNCHES == 0
