"""The tick loop of the sweep engine as one CUDA kernel per mode.

Replaces the TPU kernels `_mega_closed_kernel` / `_closed_call` (A1) and
`_mega_open_kernel` / `_open_call` (A2) of the JAX package
(`repro/kernels/sweep_megakernel.py`) and carries the host side of its
`run_mega`: the packed per-cell params block, the scenario-major sort
and the un-sort.

As beside every kernel of this package, for each of the two:

  * the plain PyTorch version is `torchbody.closed_body` /
    `torchbody.open_body` driven to completion (`_plain_closed_cells` /
    `_plain_open_cells`), the definition the kernel is held against bit
    for bit;
  * `mega_closed_cells` / `mega_open_cells` is the wrapper around the
    hand-written kernel `sweep_mega_closed_kernel`
    (`csrc/sweep_megakernel.cu`) / `sweep_mega_open_kernel`
    (`csrc/sweep_megakernel_open.cu`): it takes the plain version only
    for tensors that lie on the CPU, and for CUDA tensors launches the
    kernel or raises;
  * `LAUNCHES` / `OPEN_LAUNCHES` is a plain integer, incremented where
    the kernel is launched and nowhere else.

What bounds the kernels on an H100: latency. A cell's inputs and outputs
are a few hundred bytes and its arithmetic is a few hundred integer
operations a tick, but the ticks of one cell form a chain of small
dependent steps, most of them walks over the cell's banks and cores. The
design therefore runs a cell on a group of G lanes (G the smallest power
of two covering its banks and cores, 8 to 32): a lane owns a bank (and a
core), the walks become warp collectives over the group, and the state a
tick touches sits in registers and shared memory (`csrc/sweep_tick.cuh`
says how the serial orders are kept). Blocks stay resident and take cells
from a counter, so the scratch is a few group slots' worth (a 4096-bin
histogram each, plus closed ring queues of `B*LQ` 16-byte entries), not a
cell's worth each.

Layout: cells are sorted scenario-major (then density, then policy kind)
so that neighbouring groups replay the same demand stream and take
similar branches; each cell reads its scenario's stream plane at
`scn_of_cell` (a 10^5-cell grid carries `n_scenarios` stream copies, not
10^5): closed, the per-core streams ``sw sb sr ssub sth [NS, C, N]``
and `nreq [NS, C]`; open, the per-bank arrival FIFOs ``qa qr qs qw [NS,
B, L]`` and `npb [NS, B]`. One launch takes a card's whole share of
the grid; no pad rows are needed, and the `MP_PAD` column stays 0 and is
not read. With `n_shards` cards the sorted rows are cut into that many
contiguous shares; a card is sent its share's rows and the stream planes
of the scenarios they name, and nothing else.

Cells of up to `MAX_BANKS` global banks and `MAX_CORES` cores are taken;
past 32 of either a cell runs the kernels' wide instantiation (32 lanes,
each with up to `MAX_BANKS / 32` bank slots).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.sweep import torchbody
from repro_torch.core.sweep.engine import MAX_LAT_TICKS, _resolve_device
from repro_torch.core.sweep.fields import (MEGA_NPARAM, MEGA_NSTAT,
                                           MP_BUDGET, MP_HIT, MP_HORIZON,
                                           MP_HRA, MP_KIND, MP_LEVEL_AB,
                                           MP_MISS, MP_MLP, MP_REFI,
                                           MP_REFI_PB, MP_RFC_AB, MP_RFC_PB,
                                           MP_RTR, MP_SARP, MP_SARP_PEN,
                                           MP_TURN, MP_URGENT, MP_WR,
                                           MP_WRP, MS_FINISHED, MS_HITS,
                                           MS_LASTDONE, MS_LATSUM,
                                           MS_MAXLAG, MS_MISSES, MS_P99,
                                           MS_READS, MS_REFAB, MS_REFPB,
                                           MS_WRITES)
from repro_torch.core.sweep.policies import (KIND_AB, KIND_DARP,
                                             KIND_ELASTIC, KIND_HIRA,
                                             KIND_RDARP, KIND_RR, KIND_STAG)
from repro_torch.kernels.sweep_arbiter import arbiter_scores_torch

#: number of kernel launches made by `mega_closed_cells` in this process
LAUNCHES = 0
#: number of kernel launches made by `mega_open_cells` in this process
OPEN_LAUNCHES = 0

#: most cells a block the size rule picks: blocks stay resident, and
#: small ones fill an SM in fine steps
MAX_BLOCK_CELLS = 16

#: global banks per cell the kernels take (written into the kernels'
#: generated header as SWEEP_MAX_BANKS)
MAX_BANKS = 256
#: cores per closed-loop cell the kernels take (SWEEP_MAX_CORES)
MAX_CORES = 256

_STREAMS = ("sw", "sb", "sr", "ssub", "sth")
_OPEN_STREAMS = ("qa", "qr", "qs", "qw")


# ------------------------------------------------------------ host layout
def _pack_params(grid) -> np.ndarray:
    """One int32 row per cell (canonical cell order), MP_* columns."""
    p = np.zeros((grid.G, MEGA_NPARAM), np.int32)
    p[:, MP_KIND] = grid.kind
    p[:, MP_LEVEL_AB] = grid.level_ab
    p[:, MP_SARP] = grid.sarp
    p[:, MP_HRA] = grid.hra
    p[:, MP_WRP] = grid.wrp
    p[:, MP_URGENT] = grid.urgent_at
    p[:, MP_BUDGET] = grid.budget
    p[:, MP_REFI] = grid.REFI
    p[:, MP_REFI_PB] = grid.REFI_PB
    p[:, MP_RFC_PB] = grid.RFC_PB
    p[:, MP_RFC_AB] = grid.RFC_AB
    p[:, MP_HIT] = grid.HIT
    p[:, MP_MISS] = grid.MISS
    p[:, MP_WR] = grid.WR
    p[:, MP_TURN] = grid.TURN
    p[:, MP_RTR] = grid.RTR
    p[:, MP_SARP_PEN] = grid.SARP_PEN
    if grid.closed:
        p[:, MP_MLP] = grid.mlp_g
    p[:, MP_HORIZON] = grid.horizon
    return p


def _layout(grid) -> np.ndarray:
    """Kernel row -> canonical cell index: cells sorted scenario-major,
    then by density, then by policy kind."""
    return np.lexsort((grid.kind, grid.den_of, grid.scn_of_cell)
                      ).astype(np.int64)


# ------------------------------------------------------- plain version
def _param_consts(p: torch.Tensor, cfg) -> dict:
    """Expand packed `[n, MEGA_NPARAM]` rows into the `torchbody`
    constant planes (what the kernel reads from its params row)."""
    dev = p.device
    col = lambda j: p[:, j]
    return dict(
        phase=torch.arange(cfg.B, dtype=torch.int32, device=dev)[None, :]
        * col(MP_REFI_PB)[:, None],
        rank_phase=torch.arange(cfg.R, dtype=torch.int32, device=dev)[None, :]
        * torch.div(col(MP_REFI), cfg.R, rounding_mode="floor")[:, None],
        kind=col(MP_KIND), level_ab=col(MP_LEVEL_AB) != 0,
        sarp=col(MP_SARP) != 0, hra=col(MP_HRA) != 0,
        wrp=col(MP_WRP) != 0, urgent_at=col(MP_URGENT),
        budget=col(MP_BUDGET), REFI=col(MP_REFI), RFC_PB=col(MP_RFC_PB),
        RFC_AB=col(MP_RFC_AB), HIT=col(MP_HIT), MISS=col(MP_MISS),
        WR=col(MP_WR), TURN=col(MP_TURN), RTR=col(MP_RTR),
        SARP_PEN=col(MP_SARP_PEN),
        horizon=int(col(MP_HORIZON).max()) if p.shape[0] else 0)


def _pack_stats(out: dict, finished: torch.Tensor) -> torch.Tensor:
    """Final state planes -> the `[n, MEGA_NSTAT]` int32 block. p99 is
    the first histogram bin whose running sum reaches
    ``(99 * reads + 99) // 100`` (== ceil(0.99 * reads)); 0 without
    reads. `argmax` of the int-cast mask returns the first such bin."""
    reads = out["reads"]
    target = torch.div(99 * reads + 99, 100, rounding_mode="floor")
    reached = out["hist"].cumsum(dim=1) >= target[:, None]
    p99 = torch.argmax(reached.to(torch.int32), dim=1)
    cols = [None] * MEGA_NSTAT
    for j, v in ((MS_READS, reads), (MS_WRITES, out["writes"]),
                 (MS_HITS, out["hits"]), (MS_MISSES, out["misses"]),
                 (MS_REFPB, out["refpb"]), (MS_REFAB, out["refab"]),
                 (MS_LATSUM, out["lat_sum"]), (MS_MAXLAG, out["maxlag"]),
                 (MS_LASTDONE, out["last_done"]), (MS_P99, p99),
                 (MS_FINISHED, finished)):
        cols[j] = v.to(torch.int32)
    return torch.stack(cols, dim=1)


def _plain_closed_cells(cfg, params, scn_of_cell, streams, nreq):
    """The plain PyTorch version of the kernel: `torchbody.closed_body`
    run until every cell of the block finishes (a finished cell is inert
    in the shared loop), then the same stat reduction."""
    n, C, N = params.shape[0], cfg.C, cfg.N
    scn = scn_of_cell.to(torch.int64)
    cst = {k: streams[k][scn].reshape(n * C, N) for k in _STREAMS}
    cst["sw"] = cst["sw"] != 0
    cst["n_req"] = nreq[scn]
    cst["mlp"] = params[:, MP_MLP]
    cst.update(_param_consts(params, cfg))
    out = torchbody.run_closed(cfg, cst, arbiter_scores_torch)
    stats = _pack_stats(out, (out["remaining"] <= 0).all(dim=1))
    cf = torch.where(out["finish"] < 0, out["t"], out["finish"])
    return stats, cf.to(torch.int32), None


def _plain_open_cells(cfg, params, scn_of_cell, streams, npb):
    """The plain PyTorch version of the open-loop kernel:
    `torchbody.open_body` run until every cell of the block has served
    its requests or the horizon is reached (a finished cell is inert in
    the shared loop), then the same stat reduction."""
    n, B, L = params.shape[0], cfg.B, cfg.L
    scn = scn_of_cell.to(torch.int64)
    cst = {k: streams[k][scn].reshape(n * B, L) for k in _OPEN_STREAMS}
    cst["qw"] = cst["qw"] != 0
    cst["n_pb"] = npb[scn]
    cst["n_tot"] = cst["n_pb"].sum(dim=1).to(torch.int32)
    cst.update(_param_consts(params, cfg))
    out = torchbody.run_open(cfg, cst, arbiter_scores_torch)
    finished = out["n_served"].sum(dim=1) >= cst["n_tot"]
    return _pack_stats(out, finished), None


# ---------------------------------------------------- operations counted
def closed_operations(cfg, params, stats, ticks) -> int:
    """Integer operations the closed-loop tick loop performs for these
    cells on this data, the yardstick of `sweep_mega_closed_kernel`'s
    bound: counted from the serial form of the kernel, one thread a cell
    walking each bank and core in turn (as `_mega_closed_kernel` of the
    JAX package and the plain version spell the function): one for each
    compare, add/subtract, multiply, divide/modulo, logical or shift, and
    select that the statements spell, none for loads, stores, address
    arithmetic or loop counters. The group-of-lanes kernel computes the
    same function with other instructions; it is not recounted, so that
    the bound does not follow the implementation. Where a branch depends
    on data the outputs do not record (which `elastic` regime, a second
    `hira` scan, banks skipped before scoring) the cheapest arm is
    counted, so the sum is a floor. `params`, `stats`, `ticks` are the kernel's
    input rows and its two outputs.

    Per tick a cell runs (B banks, S subarrays, C cores, K window slots,
    R ranks, NC channels, NB banks a rank):

      loop + phase 0 + phase 1   3 + C*(K+1) + 1 + 8*C
        (`t < horizon`, `active`, `t += 1`; K slot compares and the
        `n_exp` test a core; `wroom`; per core the 3-term issue guard,
        the 3-term finish guard and the 2-term `active` update)
      and, on every tick but a finished cell's last (which breaks out
      after phase 1):
      phase 2                    1
      phase 3 (`refresh_debt`)   1 + 6*R for a level-'ab' cell, else 0
      phase 4 (`refresh_decide`) B (queue depths) + B*(12 + 2*S) (due,
        lag, S ready compares and ands, ready/idle mask bits) + the
        policy's scan (`policy_select`: 2 kind tests; then the forced
        sweep 4*B + 1 and RR 5, DARP 1 + 12*B, RDARP 1 + R + 18*B,
        ELASTIC 2 + 7*B, HIRA 11*B) + the all-bank start test (AB 14*R,
        STAG 10*R + 10, else 2) + 1 + 2*R + 2*B (`mid`, the start and
        pick loops' bit tests)
      phase 5                    1 + NC + B (drain snapshot, `b < 0` a
        channel, `has` a bank)

    and per event: 12 an issued request (slot, tail, counters, next
    issue), 57 a served one (one candidate's eligibility 4, score 14,
    hit/mid/best 4; `serve_bank` 30; ring head and window slot 5), 15 a
    per-bank refresh, 2*NB + 4 an all-bank one. Served requests stand in
    for issued ones (equal when the cell finished)."""
    B, S, C, K, R, NC, NB = (cfg.B, cfg.S, cfg.C, cfg.K, cfg.R, cfg.NC,
                             cfg.NB)
    T = ticks.long()
    T5 = (T - stats[:, MS_FINISHED].long()).clamp(min=0)
    sel, ab = _scan_operations(cfg, params)
    per_tick = 3 + C * (K + 1) + 1 + 8 * C
    per_tick5 = (1 + (params[:, MP_LEVEL_AB] != 0).long() * (1 + 6 * R)
                 + B + B * (12 + 2 * S) + sel + ab + 1 + 2 * R + 2 * B
                 + 1 + NC + B)
    served = stats[:, MS_READS].long() + stats[:, MS_WRITES].long()
    events = ((12 + 57) * served + 15 * stats[:, MS_REFPB].long()
              + (2 * NB + 4) * stats[:, MS_REFAB].long())
    return int((per_tick * T + per_tick5 * T5 + events).sum())


def _scan_operations(cfg, params) -> tuple:
    """Per-cell operations of phase 4 / C's policy scan and all-bank
    start test (`refresh_decide`, shared by both kernels), as
    `closed_operations` spells them out."""
    B, R = cfg.B, cfg.R
    kind = params[:, MP_KIND].long()
    sel = torch.full_like(kind, 2)
    ab = torch.full_like(kind, 2)
    for k, n in ((KIND_RR, 5), (KIND_DARP, 1 + 12 * B),
                 (KIND_RDARP, 1 + R + 18 * B), (KIND_ELASTIC, 2 + 7 * B),
                 (KIND_HIRA, 11 * B)):
        sel[kind == k] = 2 + 4 * B + 1 + n
    ab[kind == KIND_AB] = 14 * R
    ab[kind == KIND_STAG] = 10 * R + 10
    return sel, ab


def open_operations(cfg, params, stats, ticks) -> int:
    """Integer operations the open-loop tick loop performs for these
    cells on this data, the yardstick of `sweep_mega_open_kernel`'s
    bound: counted from the serial form of the kernel (one thread a cell,
    each bank in turn), by the rules of `closed_operations` (one for each
    compare, add/subtract, multiply, divide/modulo, logical or shift,
    and select; none for loads, stores, address arithmetic or loop
    counters; the cheapest arm where the outputs do not record a
    branch, so the sum is a floor), and, like it, not recounted from the
    group-of-lanes kernel. `params`, `stats`, `ticks` are the
    kernel's input rows and its two outputs.

    Every tick a cell runs (B banks, S subarrays, R ranks, NC channels,
    NB banks a rank):

      loop                       3 (`served < n_tot`, `t < horizon`,
                                 `t += 1`)
      phase A                    2*B + 1 (per bank the FIFO test and the
                                 queue depth; the watermark test)
      phase B (`refresh_debt`)   1, and 1 + 6*R more for a level-'ab'
                                 cell
      phase C (`refresh_decide`) B*(12 + 2*S) + the policy's scan and
                                 the all-bank start test (as in
                                 `closed_operations`) + 1 + 2*R + 2*B
      phase D                    1 + NC + B

    and per event: 4 an arrived request (the FIFO test's second compare,
    the write test, the count, the re-test) and 1 more an arrived write;
    54 a served one (one candidate's eligibility 4, score 14,
    hit/mid/best 4; `serve_bank` 30; `n_served` and `served` 2); 15 a
    per-bank refresh, 2*NB + 4 an all-bank one. Per cell once: B for
    `n_tot` and 3 + 2*(p99 + 1) for the histogram scan. Served requests
    stand in for arrived ones (equal when the cell finished)."""
    B, S, R, NC, NB = cfg.B, cfg.S, cfg.R, cfg.NC, cfg.NB
    sel, ab = _scan_operations(cfg, params)
    level_ab = (params[:, MP_LEVEL_AB] != 0).long()
    per_tick = (3 + 2 * B + 1 + 1 + level_ab * (1 + 6 * R)
                + B * (12 + 2 * S) + sel + ab + 1 + 2 * R + 2 * B
                + 1 + NC + B)
    writes = stats[:, MS_WRITES].long()
    served = stats[:, MS_READS].long() + writes
    events = ((4 + 54) * served + writes + 15 * stats[:, MS_REFPB].long()
              + (2 * NB + 4) * stats[:, MS_REFAB].long()
              + B + 3 + 2 * (stats[:, MS_P99].long() + 1))
    return int((per_tick * ticks.long() + events).sum())


# ------------------------------------------------------------- the wrapper
def _block_threads(n: int, device) -> int:
    """Cells a block (groups of G lanes) for an `n`-cell launch: the power
    of two nearest above ``n / (4 * SMs)``, between 1 and
    `MAX_BLOCK_CELLS`. A cell's tick is a chain of collectives over its
    group, so what a small grid needs is SMs to itself: at one cell a
    block the paper grid's 120 cells each take an SM. A large grid fills
    every SM with resident blocks of `MAX_BLOCK_CELLS` cells, whose
    groups take cells from a shared counter as they finish
    (`benchmarks_torch/mega_variants.py` times other sizes)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, n // (4 * sms))
    return min(MAX_BLOCK_CELLS, 1 << (want - 1).bit_length())


_PLAN_KEYS = ("G", "cells_per_block", "blocks", "shared_bytes_per_block",
              "registers", "local_bytes")


def launch_plan(cfg, n, device, threads=None) -> dict:
    """How a launch of `n` cells of `cfg` is laid out on `device` (a
    card): ``G`` lanes a cell, ``cells_per_block``, resident ``blocks``,
    ``shared_bytes_per_block``, and the kernel instantiation's
    ``registers`` and ``local_bytes`` (spills) a thread. `threads` asks
    for cells a block (None: `_block_threads`); the kernel clamps it to
    what a block holds."""
    from repro_torch.kernels import _build
    lib = _build.load()
    cells = int(threads) if threads else _block_threads(max(n, 1), device)
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    with torch.cuda.device(device):
        if cfg.closed:
            err = lib.sweep_mega_closed_plan(
                n, cfg.B, cfg.S, cfg.NB, cfg.NR, cfg.NC, cfg.C, cfg.K,
                cfg.LQ, cells, ctypes.addressof(out))
        else:
            err = lib.sweep_mega_open_plan(
                n, cfg.B, cfg.S, cfg.NB, cfg.NR, cfg.NC, cfg.L, cells,
                ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"megakernel launch plan failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    return dict(zip(_PLAN_KEYS, map(int, out)))


def _check(who, name, x, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{who}: {name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{who}: {name} is on {x.device}, expected "
                         f"{device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{who}: {name} must be int32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_cells(who, cfg, closed, params, scn_of_cell, cname, counts,
                 streams, stream_shape):
    """The checks both wrappers make before any launch: int32 contiguous
    tensors on one device, of the shapes `cfg` gives, and a bank
    hierarchy the kernels take. Returns the device."""
    if not isinstance(params, torch.Tensor) or params.dim() != 2:
        raise ValueError(f"{who}: params must be [n, MEGA_NPARAM]")
    n, device = params.shape[0], params.device
    if cfg.closed != closed:
        raise ValueError(f"{who}: cfg is not a "
                         f"{'closed' if closed else 'open'}-loop cfg")
    _check(who, "params", params, (n, MEGA_NPARAM), device)
    _check(who, "scn_of_cell", scn_of_cell, (n,), device)
    if not isinstance(counts, torch.Tensor) or counts.dim() != 2:
        raise ValueError(f"{who}: {cname} must be "
                         f"[NS, {'C' if closed else 'B'}]")
    NS = counts.shape[0]
    _check(who, cname, counts, (NS, stream_shape[0]), device)
    for k, v in streams.items():
        _check(who, k, v, (NS,) + tuple(stream_shape), device)
    if cfg.B != cfg.NC * cfg.NR * cfg.NB or cfg.R != cfg.NC * cfg.NR:
        raise ValueError(f"{who}: inconsistent bank hierarchy")
    if cfg.B > MAX_BANKS:
        raise ValueError(f"{who}: {cfg.B} banks per cell, the kernels "
                         f"take at most MAX_BANKS={MAX_BANKS}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {device}")
    return device


def mega_closed_cells(cfg, params, scn_of_cell, streams, nreq, *,
                      threads=None):
    """Run `n` closed-loop cells to completion.

    cfg         : `torchbody.TickCfg` of the grid (closed)
    params      : `[n, MEGA_NPARAM]` int32, MP_* columns, one row a cell
    scn_of_cell : `[n]` int32, the cell's scenario index
    streams     : dict of the five `[NS, C, N]` int32 per-scenario planes
                  ``sw sb sr ssub sth``
    nreq        : `[NS, C]` int32 requests per core
    threads     : cells (groups of G lanes) a block; None picks by grid
                  size (`_block_threads`); only the variants script
                  `benchmarks_torch/mega_variants.py` pins it

    Returns ``(stats [n, MEGA_NSTAT] int32, core_finish [n, C] int32,
    ticks [n] int32 or None)`` on the inputs' device. CUDA tensors go
    through the kernel — a missing compiler, a failed build or a refused
    launch raises; CPU tensors go through the plain version (which
    reports no per-cell tick counts)."""
    global LAUNCHES
    who = "mega_closed_cells"
    if not isinstance(streams, dict) or set(streams) != set(_STREAMS):
        raise ValueError(f"{who}: streams must hold {_STREAMS}")
    device = _check_cells(who, cfg, True, params, scn_of_cell, "nreq",
                          nreq, streams, (cfg.C, cfg.N))
    if cfg.LQ & (cfg.LQ - 1):
        raise ValueError(f"{who}: LQ must be a power of two")
    n = params.shape[0]
    if device.type == "cpu":
        return _plain_closed_cells(cfg, params, scn_of_cell, streams, nreq)

    if cfg.C > MAX_CORES:
        raise ValueError(f"{who}: {cfg.C} cores per cell, the kernel takes "
                         f"at most MAX_CORES={MAX_CORES}")
    from repro_torch.kernels import _build
    lib = _build.load()
    i32 = dict(dtype=torch.int32, device=device)
    stats = torch.empty((n, MEGA_NSTAT), **i32)
    cf = torch.empty((n, cfg.C), **i32)
    ticks = torch.empty((n,), **i32)
    if n == 0:
        return stats, cf, ticks
    plan = launch_plan(cfg, n, device, threads)
    slots = plan["blocks"] * plan["cells_per_block"]
    ring = torch.empty((slots, cfg.B * cfg.LQ, 4), **i32)
    hist = torch.zeros((slots, MAX_LAT_TICKS + 1), **i32)
    next_cell = torch.zeros((1,), **i32)
    with torch.cuda.device(device):
        err = lib.sweep_mega_closed_launch(
            params.data_ptr(), scn_of_cell.data_ptr(),
            *(streams[k].data_ptr() for k in _STREAMS), nreq.data_ptr(),
            stats.data_ptr(), cf.data_ptr(), ticks.data_ptr(),
            ring.data_ptr(), hist.data_ptr(), next_cell.data_ptr(),
            n, cfg.B, cfg.S, cfg.NB, cfg.NR, cfg.NC, cfg.C, cfg.N, cfg.K,
            cfg.LQ, cfg.HI, cfg.LO, cfg.CAP, plan["cells_per_block"], slots,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sweep_mega_closed_kernel launch failed: CUDA error {err} "
            f"({_build.error_string(err)})")
    LAUNCHES += 1
    return stats, cf, ticks


def mega_open_cells(cfg, params, scn_of_cell, streams, npb, *,
                    threads=None):
    """Run `n` open-loop cells to completion.

    cfg         : `torchbody.TickCfg` of the grid (open)
    params      : `[n, MEGA_NPARAM]` int32, MP_* columns, one row a cell
    scn_of_cell : `[n]` int32, the cell's scenario index
    streams     : dict of the four `[NS, B, L]` int32 per-scenario arrival
                  FIFOs ``qa qr qs qw`` (arrival tick, row, subarray,
                  write flag; `_PAD_ARRIVE` past the real entries)
    npb         : `[NS, B]` int32 real entries per FIFO
    threads     : cells (groups of G lanes) a block; None picks by grid
                  size (`_block_threads`)

    Returns ``(stats [n, MEGA_NSTAT] int32, ticks [n] int32 or None)`` on
    the inputs' device. CUDA tensors go through the kernel — a missing
    compiler, a failed build or a refused launch raises; CPU tensors go
    through the plain version (which reports no per-cell tick counts)."""
    global OPEN_LAUNCHES
    who = "mega_open_cells"
    if not isinstance(streams, dict) or set(streams) != set(_OPEN_STREAMS):
        raise ValueError(f"{who}: streams must hold {_OPEN_STREAMS}")
    device = _check_cells(who, cfg, False, params, scn_of_cell, "npb", npb,
                          streams, (cfg.B, cfg.L))
    if cfg.L < 1:
        raise ValueError(f"{who}: L must be at least 1")
    n = params.shape[0]
    if device.type == "cpu":
        return _plain_open_cells(cfg, params, scn_of_cell, streams, npb)

    from repro_torch.kernels import _build
    lib = _build.load()
    i32 = dict(dtype=torch.int32, device=device)
    stats = torch.empty((n, MEGA_NSTAT), **i32)
    ticks = torch.empty((n,), **i32)
    if n == 0:
        return stats, ticks
    plan = launch_plan(cfg, n, device, threads)
    slots = plan["blocks"] * plan["cells_per_block"]
    hist = torch.zeros((slots, MAX_LAT_TICKS + 1), **i32)
    next_cell = torch.zeros((1,), **i32)
    with torch.cuda.device(device):
        err = lib.sweep_mega_open_launch(
            params.data_ptr(), scn_of_cell.data_ptr(),
            *(streams[k].data_ptr() for k in _OPEN_STREAMS), npb.data_ptr(),
            stats.data_ptr(), ticks.data_ptr(), hist.data_ptr(),
            next_cell.data_ptr(), n, cfg.B, cfg.S, cfg.NB, cfg.NR, cfg.NC,
            cfg.L, cfg.HI, cfg.LO, plan["cells_per_block"], slots,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sweep_mega_open_kernel launch failed: CUDA error {err} "
            f"({_build.error_string(err)})")
    OPEN_LAUNCHES += 1
    return stats, ticks


# ------------------------------------------------------------------ driver
def host_inputs(grid):
    """The grid's packed inputs on the host, in kernel row order:
    ``(cfg, order, params [G, MEGA_NPARAM], scn_of_cell [G])`` as numpy
    int32 (`order` int64: kernel row -> canonical cell)."""
    cfg = (torchbody.closed_cfg(grid) if grid.closed
           else torchbody.open_cfg(grid))
    order = _layout(grid)
    params = np.ascontiguousarray(_pack_params(grid)[order], np.int32)
    scn = np.ascontiguousarray(grid.scn_of_cell[order], np.int32)
    return cfg, order, params, scn


def upload(grid, params, scn, device, r0=0, r1=None):
    """Kernel rows `r0:r1` as the mode's wrapper takes them, on
    `device`: ``(params, scn_of_cell, streams, counts)`` — `counts` is
    `nreq` closed, `npb` open. Rows are sorted scenario-major, so the
    rows name one contiguous run of scenarios: only those stream planes
    are sent, and `scn_of_cell` is re-based to index them."""
    r1 = params.shape[0] if r1 is None else r1

    def dev(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32)).to(device)

    s0, s1 = (int(scn[r0]), int(scn[r1 - 1]) + 1) if r1 > r0 else (0, 0)
    if grid.closed:
        planes = dict(sw=grid.scn_write, sb=grid.scn_bank, sr=grid.scn_row,
                      ssub=grid.scn_sub, sth=grid.scn_think)
        counts = grid.scn_nreq
    else:
        planes = dict(qa=grid.scn_qa, qr=grid.scn_qr, qs=grid.scn_qs,
                      qw=grid.scn_qw)
        counts = grid.scn_npb
    streams = {k: dev(v[s0:s1]) for k, v in planes.items()}
    return (dev(params[r0:r1]), dev(scn[r0:r1] - s0), streams,
            dev(counts[s0:s1]))


def device_inputs(grid, device):
    """The whole grid on one device: ``(cfg, order, params, scn_of_cell,
    streams, counts)``."""
    cfg, order, params, scn = host_inputs(grid)
    return (cfg, order) + upload(grid, params, scn, device)


def _shard_devices(device, n_shards):
    """The devices `n_shards` shares run on: `device` itself for one
    share, else the first `n_shards` cards; fewer visible raises."""
    if n_shards == 1:
        return [device]
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_dev < n_shards:
        raise ValueError(
            f"n_shards={n_shards} but only {n_dev} devices are visible")
    return [torch.device("cuda", i) for i in range(n_shards)]


def _shares(G, n_shards):
    """Contiguous kernel-row ranges, one per shard, ``ceil(G /
    n_shards)`` rows each (the last ones shorter or empty)."""
    per = -(-G // n_shards)
    return [(min(G, i * per), min(G, (i + 1) * per))
            for i in range(n_shards)]


def run_mega(grid, *, device=None, n_shards=1):
    """Run every cell of `grid` (an `engine._Grid`, either mode) through
    the mode's tick-loop kernel, one launch a card.

    Returns a dict of canonical-cell-order `[G]` numpy arrays (keys
    ``reads writes hits misses refpb refab lat_sum maxlag last_done p99
    finished``, ``core_finish`` `[G, C]` for a closed grid and None for
    an open one, and ``ticks`` — ticks run per cell, None on the CPU):
    the stat columns `engine._finalize_cells` takes.

    `device=None` means the card. `n_shards` cuts the kernel rows into
    that many contiguous shares, one per card (``cuda:0 ..
    cuda:n_shards-1``), and raises `ValueError` when fewer cards are
    visible; launches are asynchronous, so the cards run their shares
    side by side and results are read back after the last launch."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    devices = _shard_devices(_resolve_device(device, "mega"), n_shards)
    run = mega_closed_cells if grid.closed else mega_open_cells

    cfg, order, params_h, scn_h = host_inputs(grid)
    G = grid.G
    parts = [run(cfg, *upload(grid, params_h, scn_h, d, r0, r1))
             for d, (r0, r1) in zip(devices, _shares(G, len(devices)))
             if r1 > r0]

    def gather(i, width):
        if parts[0][i] is None:
            return None
        rows = torch.cat([p[i].cpu() for p in parts]).numpy()
        out = np.zeros((G,) + width, np.int32)
        out[order] = rows
        return out

    res = gather(0, (MEGA_NSTAT,))
    return dict(reads=res[:, MS_READS], writes=res[:, MS_WRITES],
                hits=res[:, MS_HITS], misses=res[:, MS_MISSES],
                refpb=res[:, MS_REFPB], refab=res[:, MS_REFAB],
                lat_sum=res[:, MS_LATSUM], maxlag=res[:, MS_MAXLAG],
                last_done=res[:, MS_LASTDONE], p99=res[:, MS_P99],
                finished=res[:, MS_FINISHED] != 0,
                core_finish=gather(1, (cfg.C,)) if grid.closed else None,
                ticks=gather(len(parts[0]) - 1, ()))
