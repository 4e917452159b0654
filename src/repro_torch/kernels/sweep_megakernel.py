"""The closed-loop tick loop of the sweep engine as one CUDA kernel.

Replaces the TPU kernel `_mega_closed_kernel` / `_closed_call` of the JAX
package (`repro/kernels/sweep_megakernel.py`) and carries the host side
of its `run_mega`: the packed per-cell params block, the scenario-major
sort, chunk streaming and the un-sort. The open-loop kernel
(`_mega_open_kernel`) is not ported yet.

As beside every kernel of this package:

  * the plain PyTorch version is `torchbody.closed_body` driven to
    completion (`_plain_closed_cells`), the definition the kernel is held
    against bit for bit;
  * `mega_closed_cells` is the wrapper around the hand-written kernel
    `sweep_mega_closed_kernel` (`csrc/sweep_megakernel.cu`): it takes the
    plain version only for tensors that lie on the CPU, and for CUDA
    tensors launches the kernel or raises;
  * `LAUNCHES` is a plain integer, incremented where the kernel is
    launched and nowhere else.

What bounds the kernel on an H100: latency. A cell's inputs and outputs
are a few hundred bytes and its arithmetic is a few hundred integer
operations a tick, but the ticks of one cell form a serial chain of
dependent loads and stores on that cell's own state. The design therefore
runs one cell per thread and as many cells at once as the grid has (a
10^5-cell grid fills every SM), keeps counters and bank masks in
registers, and lays the remaining per-cell state out `[word][cell]` in
global scratch so that the lanes of a warp — neighbouring cells, sorted
here to share scenario, density and policy kind — touch the same lines
while they run in step. The source's header says why a warp per cell was
not chosen.

Layout: cells are sorted scenario-major (then density, then policy kind)
so that neighbouring threads replay the same demand stream and take
similar branches; each cell reads its scenario's stream plane at
`scn_of_cell` (a 10^5-cell grid carries `n_scenarios` stream copies, not
10^5). Cells go to the device in chunks of `chunk_cells`, which bounds
the scratch (ring queues `5*B*LQ` words and a 4096-bin histogram per
cell, about 37 KB at B=8, LQ=128); no pad rows are needed, the last block
masks its tail, and the `MP_PAD` column stays 0 and is not read. With
`n_shards` cards the sorted rows are cut into that many contiguous
shares; a card is sent its share's rows and the stream planes of the
scenarios they name, and nothing else.
"""
from __future__ import annotations

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

#: device scratch a chunk may take (ring queues + histograms); the
#: default `chunk_cells` is the largest cell count that fits
SCRATCH_BYTES = 8 << 30

#: largest block the size rule picks: cells diverge, so small blocks
#: retire sooner and spread over the SMs more evenly
MAX_THREADS = 64

#: banks per cell the kernel supports (bank sets are 64-bit masks)
MAX_BANKS = 64

_STREAMS = ("sw", "sb", "sr", "ssub", "sth")


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
    p[:, MP_REFI_PB] = np.array(
        [grid.timing[d].REFI_PB for _, _, d in grid.cells], np.int32)
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
    d_index = {d: i for i, d in enumerate(grid.spec.densities)}
    d_of = np.array([d_index[d] for _, _, d in grid.cells], np.int32)
    return np.lexsort((grid.kind, d_of, grid.scn_of_cell)).astype(np.int64)


def _default_chunk(cfg) -> int:
    words = 5 * cfg.B * cfg.LQ + (MAX_LAT_TICKS + 1) + 4 * cfg.B * cfg.S
    return max(1, SCRATCH_BYTES // (4 * words))


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


# ---------------------------------------------------- operations counted
def closed_operations(cfg, params, stats, ticks) -> int:
    """Integer operations `sweep_mega_closed_kernel` performs for these
    cells on this data, counted from its source (`csrc/
    sweep_megakernel.cu`, `sweep_tick.cuh`, `sweep_score.cuh`): one for
    each compare, add/subtract, multiply, divide/modulo, logical or
    shift, and select that the statements spell, none for loads, stores,
    address arithmetic or loop counters. Where a branch depends on data
    the outputs do not record (which `elastic` regime, a second `hira`
    scan, banks skipped before scoring) the cheapest arm is counted, so
    the sum is a floor. `params`, `stats`, `ticks` are the kernel's
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
    kind = params[:, MP_KIND].long()
    T = ticks.long()
    T5 = (T - stats[:, MS_FINISHED].long()).clamp(min=0)
    sel = torch.full_like(kind, 2)
    ab = torch.full_like(kind, 2)
    for k, n in ((KIND_RR, 5), (KIND_DARP, 1 + 12 * B),
                 (KIND_RDARP, 1 + R + 18 * B), (KIND_ELASTIC, 2 + 7 * B),
                 (KIND_HIRA, 11 * B)):
        sel[kind == k] = 2 + 4 * B + 1 + n
    ab[kind == KIND_AB] = 14 * R
    ab[kind == KIND_STAG] = 10 * R + 10
    per_tick = 3 + C * (K + 1) + 1 + 8 * C
    per_tick5 = (1 + (params[:, MP_LEVEL_AB] != 0).long() * (1 + 6 * R)
                 + B + B * (12 + 2 * S) + sel + ab + 1 + 2 * R + 2 * B
                 + 1 + NC + B)
    served = stats[:, MS_READS].long() + stats[:, MS_WRITES].long()
    events = ((12 + 57) * served + 15 * stats[:, MS_REFPB].long()
              + (2 * NB + 4) * stats[:, MS_REFAB].long())
    return int((per_tick * T + per_tick5 * T5 + events).sum())


# ------------------------------------------------------------- the wrapper
def _block_threads(n: int, device) -> int:
    """Cells per block for an `n`-cell launch: the power of two nearest
    above ``n / (4 * SMs)``, between 1 and `MAX_THREADS`. A cell is a
    serial chain on its own state, so what a small grid needs is SMs and
    cache to itself, not lanes: 120 cells run ~1.8x faster one to a block
    (each on its own SM) than 64 to a block on two SMs, while 10^5 cells
    fill the card at 64 (H100, `benchmarks_torch/tune_threads.py`)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, n // (4 * sms))
    return min(MAX_THREADS, 1 << (want - 1).bit_length())


def _check(name, x, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"mega_closed_cells: {name} must be a tensor")
    if x.device != device:
        raise ValueError(f"mega_closed_cells: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != torch.int32:
        raise TypeError(f"mega_closed_cells: {name} must be int32, got "
                        f"{x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"mega_closed_cells: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"mega_closed_cells: {name} must be contiguous")


def mega_closed_cells(cfg, params, scn_of_cell, streams, nreq, *,
                      threads=None):
    """Run `n` closed-loop cells to completion.

    cfg         : `torchbody.TickCfg` of the grid (closed)
    params      : `[n, MEGA_NPARAM]` int32, MP_* columns, one row a cell
    scn_of_cell : `[n]` int32, the cell's scenario index
    streams     : dict of the five `[NS, C, N]` int32 per-scenario planes
                  ``sw sb sr ssub sth``
    nreq        : `[NS, C]` int32 requests per core
    threads     : cells per block; None picks by grid size
                  (`_block_threads`); only the block-size sweep
                  `benchmarks_torch/tune_threads.py` pins it

    Returns ``(stats [n, MEGA_NSTAT] int32, core_finish [n, C] int32,
    ticks [n] int32 or None)`` on the inputs' device. CUDA tensors go
    through the kernel — a missing compiler, a failed build or a refused
    launch raises; CPU tensors go through the plain version (which
    reports no per-cell tick counts)."""
    global LAUNCHES
    if not isinstance(params, torch.Tensor) or params.dim() != 2:
        raise ValueError("mega_closed_cells: params must be [n, "
                         "MEGA_NPARAM]")
    n, device = params.shape[0], params.device
    if not cfg.closed:
        raise ValueError("mega_closed_cells: cfg is not a closed-loop cfg")
    _check("params", params, (n, MEGA_NPARAM), device)
    _check("scn_of_cell", scn_of_cell, (n,), device)
    _check("nreq", nreq, (nreq.shape[0], cfg.C), device)
    NS = nreq.shape[0]
    for k in _STREAMS:
        _check(k, streams[k], (NS, cfg.C, cfg.N), device)
    if cfg.B != cfg.NC * cfg.NR * cfg.NB or cfg.R != cfg.NC * cfg.NR:
        raise ValueError("mega_closed_cells: inconsistent bank hierarchy")
    if cfg.B > MAX_BANKS:
        raise ValueError(f"mega_closed_cells: {cfg.B} banks per cell, the "
                         f"kernel holds bank sets in {MAX_BANKS}-bit masks")
    if cfg.LQ & (cfg.LQ - 1):
        raise ValueError("mega_closed_cells: LQ must be a power of two")

    if device.type == "cpu":
        return _plain_closed_cells(cfg, params, scn_of_cell, streams, nreq)
    if device.type != "cuda":
        raise ValueError(f"mega_closed_cells: unsupported device {device}")

    from repro_torch.kernels import _build
    lib = _build.load()
    words = int(lib.sweep_mega_closed_scratch_words(
        cfg.B, cfg.S, cfg.NC, cfg.R, cfg.C, cfg.K, cfg.LQ))
    i32 = dict(dtype=torch.int32, device=device)
    stats = torch.empty((n, MEGA_NSTAT), **i32)
    cf = torch.empty((n, cfg.C), **i32)
    ticks = torch.empty((n,), **i32)
    if n == 0:
        return stats, cf, ticks
    scratch = torch.empty((words, n), **i32)
    hist = torch.zeros((MAX_LAT_TICKS + 1, n), **i32)
    with torch.cuda.device(device):
        err = lib.sweep_mega_closed_launch(
            params.data_ptr(), scn_of_cell.data_ptr(),
            *(streams[k].data_ptr() for k in _STREAMS), nreq.data_ptr(),
            stats.data_ptr(), cf.data_ptr(), ticks.data_ptr(),
            scratch.data_ptr(), hist.data_ptr(),
            n, cfg.B, cfg.S, cfg.NB, cfg.NR, cfg.NC, cfg.C, cfg.N, cfg.K,
            cfg.LQ, cfg.HI, cfg.LO, cfg.CAP,
            int(threads) if threads else _block_threads(n, device),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sweep_mega_closed_kernel launch failed: CUDA error {err} "
            f"({_build.error_string(err)})")
    LAUNCHES += 1
    return stats, cf, ticks


# ------------------------------------------------------------------ driver
def host_inputs(grid):
    """The grid's packed inputs on the host, in kernel row order:
    ``(cfg, order, params [G, MEGA_NPARAM], scn_of_cell [G])`` as numpy
    int32 (`order` int64: kernel row -> canonical cell)."""
    cfg = torchbody.closed_cfg(grid)
    order = _layout(grid)
    params = np.ascontiguousarray(_pack_params(grid)[order], np.int32)
    scn = np.ascontiguousarray(grid.scn_of_cell[order], np.int32)
    return cfg, order, params, scn


def upload(grid, params, scn, device, r0=0, r1=None):
    """Kernel rows `r0:r1` as `mega_closed_cells` takes them, on
    `device`: ``(params, scn_of_cell, streams, nreq)``. Rows are sorted
    scenario-major, so the rows name one contiguous run of scenarios:
    only those stream planes are sent, and `scn_of_cell` is re-based to
    index them."""
    r1 = params.shape[0] if r1 is None else r1

    def dev(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32)).to(device)

    s0, s1 = (int(scn[r0]), int(scn[r1 - 1]) + 1) if r1 > r0 else (0, 0)
    streams = dict(sw=dev(grid.scn_write[s0:s1]),
                   sb=dev(grid.scn_bank[s0:s1]),
                   sr=dev(grid.scn_row[s0:s1]),
                   ssub=dev(grid.scn_sub[s0:s1]),
                   sth=dev(grid.scn_think[s0:s1]))
    return (dev(params[r0:r1]), dev(scn[r0:r1] - s0), streams,
            dev(grid.scn_nreq[s0:s1]))


def device_inputs(grid, device):
    """The whole grid on one device: ``(cfg, order, params, scn_of_cell,
    streams, nreq)``."""
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


def run_mega(grid, *, device=None, n_shards=1, chunk_cells=None):
    """Run every cell of `grid` (an `engine._Grid` built with
    ``stack_streams=False``, closed mode) through the tick-loop kernel.

    Returns a dict of canonical-cell-order `[G]` numpy arrays (keys
    ``reads writes hits misses refpb refab lat_sum maxlag last_done p99
    finished``, ``core_finish`` `[G, C]`, and ``ticks`` — ticks run per
    cell, None on the CPU) — exactly the inputs `engine._finalize` needs.

    `device=None` means the card; `chunk_cells` bounds the cells per
    launch (default: what `SCRATCH_BYTES` of scratch holds). `n_shards`
    cuts the kernel rows into that many contiguous shares, one per card
    (``cuda:0 .. cuda:n_shards-1``), and raises `ValueError` when fewer
    cards are visible; launches are asynchronous, so the cards run their
    shares side by side and results are read back after the last
    launch."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not grid.closed:
        raise NotImplementedError(
            "the open-loop tick-loop kernel is not ported yet: "
            "backend='mega' runs mode='closed' grids only")
    devices = _shard_devices(_resolve_device(device, "mega"), n_shards)

    cfg, order, params_h, scn_h = host_inputs(grid)
    G = grid.G
    chunk = int(chunk_cells) if chunk_cells else _default_chunk(cfg)
    chunk = max(1, chunk)
    parts = []
    for d, (r0, r1) in zip(devices, _shares(G, len(devices))):
        if r1 == r0:
            continue
        params, scn, streams, nreq = upload(grid, params_h, scn_h, d,
                                            r0, r1)
        for c0 in range(0, r1 - r0, chunk):
            parts.append(mega_closed_cells(
                cfg, params[c0:c0 + chunk], scn[c0:c0 + chunk], streams,
                nreq))
    stats = torch.cat([p[0].cpu() for p in parts]).numpy()
    cf = torch.cat([p[1].cpu() for p in parts]).numpy()
    ticks = (None if parts[0][2] is None
             else torch.cat([p[2].cpu() for p in parts]).numpy())

    res = np.zeros((G, MEGA_NSTAT), np.int32)
    res[order] = stats
    cf_g = np.zeros((G, cfg.C), np.int32)
    cf_g[order] = cf
    out = dict(reads=res[:, MS_READS], writes=res[:, MS_WRITES],
               hits=res[:, MS_HITS], misses=res[:, MS_MISSES],
               refpb=res[:, MS_REFPB], refab=res[:, MS_REFAB],
               lat_sum=res[:, MS_LATSUM], maxlag=res[:, MS_MAXLAG],
               last_done=res[:, MS_LASTDONE], p99=res[:, MS_P99],
               finished=res[:, MS_FINISHED] != 0, core_finish=cf_g,
               ticks=None)
    if ticks is not None:
        out["ticks"] = np.zeros(G, np.int32)
        out["ticks"][order] = ticks
    return out
