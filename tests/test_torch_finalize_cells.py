"""The port's vectorized `_finalize_cells` against the JAX package's
per-cell `_finalize`, on the same integer stat columns: every
`CellResult` field equal, each float by its IEEE bits, and each field of
the same Python type (`int`, `float`, `bool`, a `tuple` of `float`).

Cases: a closed grid of the paper's system (2 channels x 2 ranks x 8
banks, 8 cores) over 3 densities; 4-core beside 8-core scenarios, with
the columns past a scenario's cores set high; cells that read nothing;
latency sums and finish ticks at the int32 limit; open grids with the
in-kernel p99 and with histograms; a closed grid with histograms; both
modes at a tick of 5/3 ns, where float sums round; a one-cell grid; the
per-cell `_finalize` the scalar backends call; and `sweep` on `mega` (its
plain path on the CPU) against `scalar`."""
from __future__ import annotations

import dataclasses
import struct

import numpy as np
import pytest

from repro.core.sweep import SweepSpec as RefSpec
from repro.core.sweep import engine as ref_engine
from repro_torch.core.sweep import SweepSpec, sweep
from repro_torch.core.sweep import engine

from _torch_parity import CELL_FIELDS

INT32_MAX = 2 ** 31 - 1
H = engine.MAX_LAT_TICKS + 1
#: the paper's system (Table 1) as `perfbench/configs/dram-closed-8b8s`
PAPER = dict(n_channels=2, n_ranks=2, n_banks=8, n_subarrays=8,
             densities=(8, 16, 32), reqs=64, seed=5)
PAPER_POLICIES = ("all_bank", "darp", "dsarp", "elastic", "hira", "ideal",
                  "ref_ab", "ref_pb", "sarp_pb", "staggered_ab")


def _grids(**kw):
    """The port's grid (the megakernel's layout) and the reference's."""
    return (engine._Grid(SweepSpec(**kw)),
            ref_engine._Grid(RefSpec(**kw), stack_streams=False))


def _columns(grid, seed: int, *, p99: bool, zero_reads: float = 0.1,
             at_limit: bool = False, pad_high: bool = False,
             ticks: int = 1 << 24) -> dict:
    """Seeded `[G]` stat columns shaped like a backend's (int32, the
    closed grids' `core_finish` `[G, C]`, `hist` `[G, H]` when not
    `p99`), finishing under `ticks`."""
    rs = np.random.RandomState(seed)
    G = grid.G
    i32 = lambda lo, hi, shape=(G,): rs.randint(lo, hi, shape).astype(
        np.int32)
    cols = dict(writes=i32(0, 5000), hits=i32(0, 9000), misses=i32(0, 9000),
                refpb=i32(0, 400), refab=i32(0, 60), maxlag=i32(0, 12),
                last_done=i32(1, ticks), finished=rs.rand(G) < 0.8)
    if p99:
        reads = i32(0, 9000)
        cols["p99"] = i32(0, H)
    else:
        hist = np.zeros((G, H), np.int32)
        for g in range(G):
            n = rs.randint(1, 60)
            np.add.at(hist[g], rs.randint(0, H, n) ** 2 % H,
                      rs.randint(1, 200, n))
        reads = hist.sum(axis=1).astype(np.int32)
        # reads past the histogram's total: p99 at its end
        reads[rs.rand(G) < 0.1] += 50
        cols["hist"] = hist
    reads[rs.rand(G) < zero_reads] = 0
    cols["reads"] = reads
    cols["lat_sum"] = (reads.astype(np.int64) * rs.randint(1, H, G)
                       ).clip(0, INT32_MAX).astype(np.int32)
    if at_limit:
        cols["lat_sum"] = (INT32_MAX - i32(0, 1000)) * (reads != 0)
    if grid.closed:
        fin = i32(0, ticks, (G, grid.C))
        if at_limit:
            fin = INT32_MAX - i32(0, 1000, (G, grid.C))
        if pad_high:
            # a scenario's unused columns finish last, so dropping the
            # core mask moves makespan
            nc = np.array([grid.demands[engine._scenario_name(s)].n_cores
                           for _, s, _ in grid.cells])
            fin[np.arange(grid.C) >= nc[:, None]] = INT32_MAX
        cols["core_finish"] = fin
    return cols


def _reference(ref_grid, cols: dict) -> list:
    """The JAX package's `_finalize`, a cell at a time."""
    per = lambda k, g: None if cols.get(k) is None else cols[k][g]
    return [ref_engine._finalize(
        ref_grid, g, reads=cols["reads"][g], writes=cols["writes"][g],
        hits=cols["hits"][g], misses=cols["misses"][g],
        refpb=cols["refpb"][g], refab=cols["refab"][g],
        lat_sum=cols["lat_sum"][g], hist=per("hist", g),
        maxlag=cols["maxlag"][g], last_done=cols["last_done"][g],
        finished=cols["finished"][g], core_finish=per("core_finish", g),
        p99=per("p99", g)) for g in range(ref_grid.G)]


def _against_reference(seed: int, spec: dict, **kw):
    grid, ref_grid = _grids(**spec)
    cols = _columns(grid, seed, **kw)
    return engine._finalize_cells(grid, **cols), _reference(ref_grid, cols)


def _wrapper():
    """The scalar backends' per-cell `_finalize`, on Python ints."""
    grid, ref_grid = _grids(policies=("ideal", "darp", "ref_ab"),
                            scenarios=("closed_mixed", "closed_multirank"),
                            mode="closed", **PAPER)
    cols = _columns(grid, 17, p99=False, pad_high=True)
    got = []
    for g in range(grid.G):
        row = {k: (v[g].tolist() if k in ("hist", "core_finish")
                   else v[g].item()) for k, v in cols.items()}
        row["hist"] = np.asarray(row["hist"], np.int32)
        got.append(engine._finalize(grid, g, **row))
    return got, _reference(ref_grid, cols)


def _mega_against_scalar():
    spec = SweepSpec(policies=("ideal", "ref_ab", "darp", "dsarp"),
                     scenarios=("closed_mixed", "closed_multirank"),
                     densities=(8, 32), reqs=48, seed=11, mode="closed",
                     n_ranks=2, n_channels=2)
    return (sweep(spec, backend="mega", device="cpu").cells,
            sweep(spec, backend="scalar").cells)


CLOSED = dict(mode="closed", **PAPER)
CASES = {
    "paper_system_closed": lambda: _against_reference(
        1, dict(policies=PAPER_POLICIES, scenarios=("closed_multirank",),
                **CLOSED), p99=True),
    "fewer_cores_than_grid": lambda: _against_reference(
        2, dict(policies=("ideal", "darp", "dsarp", "ref_ab"),
                scenarios=("closed_mixed", "closed_multirank",
                           "closed_low_mlp"), **CLOSED),
        p99=True, pad_high=True),
    "reads_zero": lambda: _against_reference(
        3, dict(policies=("ideal", "darp"),
                scenarios=("closed_mixed", "closed_multirank"), **CLOSED),
        p99=True, zero_reads=0.5),
    "int32_limit": lambda: _against_reference(
        4, dict(policies=("ideal", "darp", "ref_pb"),
                scenarios=("closed_mixed", "closed_multirank"), **CLOSED),
        p99=True, at_limit=True),
    "open_p99": lambda: _against_reference(
        5, dict(policies=("ideal", "ref_ab", "darp"),
                scenarios=("mixed", "read_heavy"), **PAPER), p99=True),
    "open_hist": lambda: _against_reference(
        6, dict(policies=("ideal", "ref_ab", "darp"),
                scenarios=("mixed", "bank_camping"), **PAPER), p99=False),
    "closed_hist": lambda: _against_reference(
        7, dict(policies=("ideal", "dsarp", "ref_ab"),
                scenarios=("closed_mixed", "closed_multirank"), **CLOSED),
        p99=False, pad_high=True),
    # a tick of 5/3 ns (a burst of 8 at DDR5-4800): makespans carry every
    # mantissa bit, and at short makespans the energy's sum rounds at
    # each power of two it crosses, so its terms' order shows
    "fine_tick_closed": lambda: _against_reference(
        9, dict(policies=("ideal", "darp", "dsarp", "ref_ab"),
                scenarios=("closed_mixed", "closed_multirank"),
                **{**CLOSED, "dt_ns": 5 / 3}), p99=False, ticks=1 << 12),
    "fine_tick_open": lambda: _against_reference(
        10, dict(policies=("ideal", "darp", "ref_ab"),
                 scenarios=("mixed", "read_heavy"),
                 **{**PAPER, "dt_ns": 5 / 3}), p99=True, ticks=1 << 12),
    "one_cell": lambda: _against_reference(
        8, dict(policies=("darp",), scenarios=("closed_mixed",),
                **{**CLOSED, "densities": (16,)}), p99=True),
    "per_cell_wrapper": _wrapper,
    "mega_cpu_against_scalar": _mega_against_scalar,
}


def _bits(v):
    """A field's value with its type, floats by their IEEE bits."""
    if isinstance(v, float):
        return float, struct.pack("d", v)
    if isinstance(v, tuple):
        return tuple, tuple(_bits(x) for x in v)
    return type(v), v


@pytest.mark.parametrize("case", list(CASES))
def test_finalize_cells_bit_identical(case):
    got, want = CASES[case]()
    assert len(got) == len(want) > 0
    assert tuple(f.name for f in dataclasses.fields(got[0])) == CELL_FIELDS
    for i, (a, b) in enumerate(zip(got, want)):
        for f in CELL_FIELDS:
            assert _bits(getattr(a, f)) == _bits(getattr(b, f)), (i, f)
