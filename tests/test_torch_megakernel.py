"""Port parity, megakernel backend: `sweep(..., backend="mega")` of
`repro_torch` against the JAX package's megakernel (Pallas interpret mode
off-TPU) and `batched` backends. On CPU tensors the port's wrapper runs
the kernel's plain PyTorch version through the same host layout
(`_pack_params`, sort, chunking, un-sort), which is what these tests
cover; the CUDA kernel itself is held against the plain version on the
card (`chip_smoke.py`, and the `gpu`-marked tests in
`tests/test_torch_gpu.py`). Tolerance: none (exact equality)."""
import numpy as np
import pytest
import torch

from repro.core.policy import list_policies
from repro.core.sweep import SweepSpec as RefSpec, sweep as ref_sweep
from repro.core.sweep import engine as ref_engine
from repro.kernels import sweep_megakernel as ref_mega

from repro_torch.core.sweep import SweepSpec, sweep
from repro_torch.core.sweep.engine import _Grid
from repro_torch.kernels import sweep_arbiter as tarb
from repro_torch.kernels import sweep_megakernel as mega

from _torch_parity import assert_cells_equal, spec_kwargs

POLICIES = tuple(list_policies())


def test_mega_cpu_equals_reference_mega_and_batched():
    kw = spec_kwargs("kernels", None)
    port = sweep(SweepSpec(**kw), "mega", device="cpu")
    assert port.backend == "mega" and set(port.seconds) == {
        "grid", "run", "finalize"}
    assert_cells_equal(ref_sweep(RefSpec(**kw), "mega"), port, "ref mega")
    assert_cells_equal(ref_sweep(RefSpec(**kw), "batched"), port, "batched")


@pytest.mark.parametrize("grid", ["conformance", "multirank", "subarray1",
                                  "subarray4"])
def test_mega_cpu_equals_reference_batched(grid):
    kw = spec_kwargs(grid, POLICIES)
    port = sweep(SweepSpec(**kw), "mega", device="cpu")
    assert all(c.finished for c in port.cells)
    assert_cells_equal(ref_sweep(RefSpec(**kw), "batched"), port, grid)


@pytest.mark.parametrize("chunk_cells", [1, 5, 13])
def test_mega_invariant_to_chunk_shape(chunk_cells):
    """Chunking is a pure dispatch choice: small odd chunks (cells of one
    scenario split across launches) reproduce the default exactly."""
    grid = _Grid(SweepSpec(**spec_kwargs("kernels", None)),
                 stack_streams=False)
    base = mega.run_mega(grid, device="cpu")
    odd = mega.run_mega(grid, device="cpu", chunk_cells=chunk_cells)
    assert set(base) == set(odd)
    for k in base:
        if base[k] is not None:
            np.testing.assert_array_equal(base[k], odd[k], k)


def test_mega_unfinished_cells_report_the_horizon():
    """A horizon too short to finish: every backend reports
    core_finish = horizon for the cores still running."""
    kw = dict(spec_kwargs("kernels", None), horizon=40)
    port = sweep(SweepSpec(**kw), "mega", device="cpu")
    assert not all(c.finished for c in port.cells)
    assert_cells_equal(ref_sweep(RefSpec(**kw), "batched"), port, "horizon")


def test_pack_params_and_layout_equal_reference():
    kw = spec_kwargs("conformance", POLICIES)
    rgrid = ref_engine._Grid(RefSpec(**kw), stack_streams=False)
    grid = _Grid(SweepSpec(**kw), stack_streams=False)
    np.testing.assert_array_equal(mega._pack_params(grid),
                                  ref_mega._pack_params(rgrid))
    order = mega._layout(grid)
    assert sorted(order.tolist()) == list(range(grid.G))
    rows, _, _ = ref_mega._layout(rgrid, tile=grid.G)
    np.testing.assert_array_equal(order, rows[rows >= 0])
    for name in ("scn_write", "scn_bank", "scn_row", "scn_sub",
                 "scn_think", "scn_nreq", "scn_of_cell"):
        np.testing.assert_array_equal(getattr(grid, name),
                                      getattr(rgrid, name), name)
    assert grid.horizon == rgrid.horizon and grid.LQ == rgrid.LQ == 128


def test_mega_record_commands_reconciles():
    kw = spec_kwargs("kernels", None)
    port = sweep(SweepSpec(**kw), "mega", device="cpu",
                 record_commands=True)
    ref = ref_sweep(RefSpec(**kw), "batched", record_commands=True)
    assert_cells_equal(ref, port, "record_commands")
    tr = port.commands_for("dsarp", "closed_mixed", 32)
    assert tr.to_json() == ref.commands_for(
        "dsarp", "closed_mixed", 32).to_json()


def test_mega_n_shards_without_devices_raises():
    spec = SweepSpec(**spec_kwargs("kernels", None))
    with pytest.raises(ValueError, match="n_shards=2"):
        sweep(spec, "mega", n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        sweep(spec, "mega", n_shards=0, device="cpu")


@pytest.mark.parametrize("n_shards,chunk_cells", [(2, None), (4, None),
                                                  (3, 7), (64, None)])
def test_mega_shards_cover_the_grid_in_contiguous_shares(
        monkeypatch, n_shards, chunk_cells):
    """With the device list faked (every shard on the CPU): each shard
    gets one contiguous share of ``ceil(G / n_shards)`` kernel rows, is
    sent only the stream planes its rows name, every row is launched
    exactly once, and the result equals the one-shard run."""
    grid = _Grid(SweepSpec(**spec_kwargs("kernels", None)),
                 stack_streams=False)
    base = mega.run_mega(grid, device="cpu")
    G, cpu = grid.G, torch.device("cpu")
    monkeypatch.setattr(mega, "_shard_devices", lambda d, n: [cpu] * n)
    uploads, launches = [], []
    real_upload, real_cells = mega.upload, mega.mega_closed_cells

    def upload(grid, params, scn, device, r0=0, r1=None):
        out = real_upload(grid, params, scn, device, r0, r1)
        uploads.append((r0, r1, out[3].shape[0], int(out[1].min()),
                        len(set(scn[r0:r1].tolist()))))
        return out

    def cells(cfg, params, scn, streams, nreq):
        launches.append(params.shape[0])
        return real_cells(cfg, params, scn, streams, nreq)

    monkeypatch.setattr(mega, "upload", upload)
    monkeypatch.setattr(mega, "mega_closed_cells", cells)
    got = mega.run_mega(grid, device="cpu", n_shards=n_shards,
                        chunk_cells=chunk_cells)
    per = -(-G // n_shards)
    assert len(uploads) == min(n_shards, -(-G // per))
    assert [u[0] for u in uploads] == list(range(0, G, per))
    assert all(r1 - r0 == min(per, G - r0) for r0, r1, *_ in uploads)
    # a share carries its own scenarios' planes only, indexed from 0
    assert all(ns == used and lo == 0 for _, _, ns, lo, used in uploads)
    assert sum(launches) == G
    assert max(launches) <= min(per, chunk_cells or per)
    for k in base:
        if base[k] is not None:
            np.testing.assert_array_equal(base[k], got[k], k)


def test_closed_operations_counts_one_cell_by_hand():
    """`closed_operations` on one `ideal` cell, against the sum spelled
    out from its docstring."""
    from repro_torch.core.sweep.fields import (MEGA_NPARAM, MEGA_NSTAT,
                                               MS_FINISHED, MS_READS,
                                               MS_WRITES)
    grid = _Grid(SweepSpec(**spec_kwargs("kernels", None)),
                 stack_streams=False)
    cfg = mega.host_inputs(grid)[0]
    B, S, C, K, R, NC = cfg.B, cfg.S, cfg.C, cfg.K, cfg.R, cfg.NC
    params = torch.zeros((1, MEGA_NPARAM), dtype=torch.int32)   # KIND_IDEAL
    stats = torch.zeros((1, MEGA_NSTAT), dtype=torch.int32)
    stats[0, MS_READS], stats[0, MS_WRITES] = 5, 2
    stats[0, MS_FINISHED] = 1
    ticks = torch.tensor([10], dtype=torch.int32)
    tick = 3 + C * (K + 1) + 1 + 8 * C
    tick5 = (1 + B + B * (12 + 2 * S) + 2 + 2 + 1 + 2 * R + 2 * B
             + 1 + NC + B)
    assert mega.closed_operations(cfg, params, stats, ticks) == (
        10 * tick + 9 * tick5 + 7 * (12 + 57))


def test_default_device_is_the_card_and_a_missing_card_raises():
    """No silent CPU run: the default device is CUDA, and without a card
    every tensor backend raises before doing any work."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    spec = SweepSpec(**spec_kwargs("kernels", None))
    before = (mega.LAUNCHES, tarb.LAUNCHES)
    for backend, kw in (("mega", {}), ("torch", {}),
                        ("batched", {"arbiter": "cuda"}),
                        ("mega", {"device": "cuda"}),
                        ("torch", {"device": "cuda:0"})):
        with pytest.raises(RuntimeError, match="is_available"):
            sweep(spec, backend, **kw)
    with pytest.raises(RuntimeError, match="is_available"):
        sweep(spec)                               # default backend
    assert (mega.LAUNCHES, tarb.LAUNCHES) == before == (0, 0)


def test_mega_custom_policy_points_at_batched():
    from repro_torch.core.policy import PolicyBase
    from repro_torch.core.policy import registry

    class Custom(PolicyBase):
        name = "torch_test_custom_mega"

        def select(self, view):
            return []

    registry.register_policy("torch_test_custom_mega", Custom,
                             override=True)
    try:
        spec = SweepSpec(policies=("torch_test_custom_mega",),
                         scenarios=("closed_mixed",), densities=(8,),
                         reqs=32, mode="closed")
        with pytest.raises(ValueError, match="backend='batched'"):
            sweep(spec, "mega", device="cpu")
    finally:
        registry._REGISTRY.pop("torch_test_custom_mega")


@pytest.mark.parametrize("fault", ["dtype", "shape", "stride", "banks"])
def test_mega_wrapper_rejects_bad_inputs(fault):
    import dataclasses
    grid = _Grid(SweepSpec(**spec_kwargs("kernels", None)),
                 stack_streams=False)
    cfg, _, params, scn, streams, nreq = mega.device_inputs(grid, "cpu")
    if fault == "dtype":
        params = params.to(torch.int64)
    elif fault == "shape":
        scn = scn[:-1]
    elif fault == "stride":
        streams = dict(streams, sb=streams["sb"].transpose(1, 2))
    else:
        cfg = dataclasses.replace(cfg, B=128, NB=128)
    with pytest.raises((TypeError, ValueError)):
        mega.mega_closed_cells(cfg, params, scn, streams, nreq)
