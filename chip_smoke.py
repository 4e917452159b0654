#!/usr/bin/env python3
"""Device check of the PyTorch/CUDA port: `python3 chip_smoke.py`.

Needs one NVIDIA GPU (written for an H100), PyTorch built for CUDA and
`nvcc`; takes no arguments; needs no network. It drives the port
(`src/repro_torch`) only — nothing of JAX, nothing of the JAX package —
and prints one JSON object a line:

  1. card     the card's name and power limit, as `nvidia-smi` gives them
              (also printed once as the raw CSV line);
  2. build    the `nvcc` build of `src/repro_torch/kernels/csrc/*.cu` from
              the sources in this checkout, with its seconds;
  3. kernels  each CUDA kernel against its plain PyTorch version on the
              card, exact (all-integer: the tolerance is 0):
              the arbiter kernel on random planes with ties and ineligible
              rows at G=100128, B=8, closed (`occ`) and open form; each
              tick-loop megakernel (closed A1, open A2) against
              `backend="torch"` on the card and `backend="batched"` on
              the host over the conformance, multirank and subarray grids
              of its mode; both megakernels on 128-bank cells (16 banks x
              4 ranks x 2 channels, their wide instantiation) against
              their plain versions on the same device inputs; the float
              kernels C (paged attention), D (kv_quant), E (flash
              attention) and F (Mamba2 SSD) against their plain versions
              at small edge shapes (a zero-length sequence, -1 table
              padding, GQA groups 1, 5 and 16, S=16 and 64, both input
              types)
              at the bars `FLASH_TOL`, `PAGED_TOL`, `SSD_TOL` (the
              reference's in float32; one rounding of the output in
              bfloat16) and kv_quant's (scales rtol 1e-4, int8 within 1);
  4. paper    the main path at the paper's grid: figure-3 policies x the
              closed figure scenarios x 3 densities, reqs=2000, seeds 1
              and 2, through `sweep(spec)` (default backend: the
              megakernel on the card), mean weighted-speedup loss vs the
              no-refresh ideal per policy and density (path `paper_mega`);
              then seed 1 again through `sweep(spec, "batched",
              arbiter="cuda")` - the host-driven numpy path whose scoring
              step is the arbiter kernel - held equal to the megakernel's
              cells (path `paper_batched_arbiter`);
  5. full     the main path at full width: every registered policy x 2384
              seed-varied closed demands x 3 densities = 100128 cells
              (reqs=32) through `sweep(spec, backend="mega")`, the last 24
              scenarios' 1008 cells held equal to `backend="batched"`;
              seconds split into demand generation, grid build, device
              run (upload, launch, download) and finalize (path
              `ladder_mega`); then the same grid through `sweep(spec,
              "torch", arbiter="cuda")`, the host-driven torch tick body
              whose scoring step is the arbiter kernel at [100128, 8], all
              100128 cells held equal to the megakernel's (path
              `ladder_torch_arbiter`);
  6. open     the open-loop main path (`SweepSpec(mode="open")`, the
              spec's default): the reference's open grid, 8 policies x 8
              scenarios x 3 densities = 192 cells, reqs=400, seed 0,
              through `sweep(spec)` (kernel A2), equal to
              `backend="batched"` on the host (path `open_grid_mega`);
              the same grid through `sweep(spec, "batched",
              arbiter="cuda")` and `sweep(spec, "torch", arbiter="cuda")`,
              the arbiter kernel in its open form, both equal to A2's
              cells (paths `open_grid_batched_arbiter`,
              `open_grid_torch_arbiter`); then the open ladder rung, every
              registered policy x 2384 seed-varied open traces x 3
              densities = 100128 cells (reqs=400), through `sweep(spec)`,
              its last 24 traces' 1008 cells held equal to `batched`
              (path `open_ladder_mega`);
  7. ops      the float-kernel entry point `repro_torch.kernels.ops` at
              full model widths: Qwen2.5-14B decode - f32 K/V pages
              [4104, 64, 8, 128] quantized by `ops.kv_quant` (D), 8
              sequences of up to 32768 tokens attended by
              `ops.refresh_paged_attention` (C), held against the plain
              versions and `ops.paged_attention_serial` (path
              `ops_paged_decode`); Qwen2.5-14B prefill, [40, 4096, 128]
              causal in bf16 and f32 through `ops.flash_attention` (E),
              and `ops.flash_attention_trainable`'s gradients at S=512
              (path `ops_prefill_flash`); mamba2-130m's SSD, x [8, 4096,
              24, 64] through `ops.mamba2_ssd` (F) (path `ops_ssd`).

The megakernels score inside their own tick loops and never call the
arbiter kernel: the arbiter kernel is on the `arbiter="cuda"` paths only.
The seven kernels' launch counters are set to 0 just before each of the
eleven paths and read just after it, and reported per path; a path that
did not launch its kernels fails the run. Afterwards each kernel is timed
at the shape its full-width path gives it (CUDA events) beside its plain
version and its bound (and E beside `scaled_dot_product_attention`, C
beside `ops.paged_attention_serial`); the megakernels are held against
their plain versions once more at that shape; the arbiter kernel is also
timed at the paper path's [120, 8]. Those launches are not counted. TF32
is switched off, so the plain versions compute in full float32. The line before the last is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``. Any
failing phase raises: the exit code is then non-zero and no result line
is printed.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks used for the bounds (NVIDIA data sheet):
# device memory rate, and the float32 rate outside the tensor cores. The
# kernels here do int32 arithmetic: the SM issues int32 on half of its
# float32 lanes and the float32 figure counts a fused multiply-add as 2.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT32_OPS = FP32_FLOPS / 4

FIG3_POLICIES = ("ref_ab", "ref_pb", "darp", "sarp_pb", "dsarp", "elastic",
                 "hira", "ideal")
CLOSED_FIG_SCENARIOS = ("closed_mixed", "closed_read_heavy",
                        "closed_write_heavy", "closed_low_mlp",
                        "closed_streaming")
DENSITIES = (8, 16, 32)
FIG_SEEDS = (1, 2)
MEGA_BASE_SCENARIOS = ("closed_mixed", "closed_read_heavy",
                       "closed_write_heavy", "closed_streaming")
LADDER_SCENARIOS = 2384          # the 1e5 rung: 14 x 2384 x 3 = 100128
ARBITER_G, ARBITER_B = 100128, 8
# the reference's open grid (benchmarks/fig_refresh.py `sweep_grid`)
GRID_POLICIES = ("ideal", "ref_ab", "ref_pb", "darp", "darp_ooo",
                 "sarp_pb", "dsarp", "elastic")
GRID_SCENARIOS = ("read_heavy", "write_burst_draining",
                  "row_buffer_friendly", "bank_camping",
                  "subarray_conflict_adversarial", "trace_replay", "mixed",
                  "streaming")
OPEN_REQS = 400
# one registered policy of each vectorized kind, for the 128-bank checks
ONE_PER_KIND = ("ideal", "ref_ab", "staggered_ab", "ref_pb", "darp",
                "rank_aware_darp", "elastic", "hira")


def emit(obj):
    print(json.dumps(obj), flush=True)


def cells_differ(a, b):
    """Count of cells that differ in any `CellResult` field."""
    assert len(a.cells) == len(b.cells)
    return sum(x != y for x, y in zip(a.cells, b.cells))


def require_equal(a, b, what):
    n = cells_differ(a, b)
    if n:
        bad = next((x, y) for x, y in zip(a.cells, b.cells) if x != y)
        raise AssertionError(f"{what}: {n} of {len(a.cells)} cells differ, "
                             f"first {bad}")


def time_cuda(torch, fn, reps, stall_ms=0):
    """Mean device milliseconds of `fn(i)` over a run of `reps` calls
    between one pair of CUDA events (one warm-up call first). A call
    shorter than the host takes to enqueue it would otherwise be timed at
    the host's pace: `stall_ms` of device-side fills are queued ahead of
    the first event so that the host runs ahead and the device finds the
    whole run waiting."""
    fn(0)
    torch.cuda.synchronize()
    if stall_ms:
        junk = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
        for _ in range(int(stall_ms / 0.3) + 1):   # ~0.3 ms a 1 GiB fill
            junk.fill_(1)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ------------------------------------------------------------- phase 3
def arbiter_planes(torch, np, seed, with_occ, G=ARBITER_G):
    """Random arbitration planes on the card, int32: ages planted equal
    (ties), whole rows ineligible, some arrivals far enough back to
    saturate the age field."""
    B = ARBITER_B
    rs = np.random.RandomState(seed)
    t = 50000
    p = dict(
        has_req=rs.rand(G, B) < 0.7,
        head_row=rs.randint(0, 4, (G, B)),
        head_arrive=t - rs.randint(0, 3, (G, B)) * 100,
        head_is_write=rs.rand(G, B) < 0.4,
        bank_free=rs.randint(t - 50, t + 50, (G, B)),
        head_ref_until=rs.randint(t - 80, t + 20, (G, B)),
        bank_mid_ref=rs.rand(G, B) < 0.3,
        open_row=rs.randint(-1, 4, (G, B)),
        drain=rs.rand(G) < 0.5,
        rank_drain=np.repeat(rs.rand(G, 1) < 0.2, B, axis=1))
    p["has_req"][rs.rand(G) < 0.1] = False
    p["head_arrive"][rs.rand(G) < 0.05] = -(1 << 21)
    if with_occ:
        p["occ"] = rs.randint(0, 12, (G, B))
    return t, {k: torch.from_numpy(np.ascontiguousarray(
        v.astype(np.int32))).cuda() for k, v in p.items()}


def check_arbiter(torch, np):
    from repro_torch.kernels import sweep_arbiter as arb
    err = 0
    for with_occ in (True, False):
        t, p = arbiter_planes(torch, np, 3 + with_occ, with_occ)
        got = arb.sweep_arbiter(t, **p)
        want = arb.arbiter_scores_torch(t, **p)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise AssertionError("arbiter kernel: wrong dtype or shape")
        err = max(err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(
                f"arbiter kernel differs from its plain version "
                f"(occ={'yes' if with_occ else 'no'}): max abs {err}")
        n_inel = int((want == -1).sum())
        if n_inel == 0 or n_inel == want.numel():
            raise AssertionError("arbiter check planted no mix of rows")
    return err


def time_arbiter(torch, np, G):
    """Kernel and plain version at `[G, 8]` (closed form). Four input
    sets are rotated so that, at the full width, each launch finds its
    ~35 MB of planes outside the 50 MB L2, as a caller streaming over a
    grid would."""
    from repro_torch.kernels import sweep_arbiter as arb
    sets = [arbiter_planes(torch, np, 20 + i, True, G) for i in range(4)]
    ms = time_cuda(torch, lambda i: arb.sweep_arbiter(
        sets[i % 4][0], **sets[i % 4][1]), 40, stall_ms=10)
    plain = time_cuda(torch, lambda i: arb.arbiter_scores_torch(
        sets[i % 4][0], **sets[i % 4][1]), 40, stall_ms=40)
    B = ARBITER_B
    nbytes = (11 * G * B + G) * 4
    # eligibility 4 + the packed score 14 (`csrc/sweep_score.cuh`)
    ops = 18 * G * B
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS
    return dict(G=G, B=B, ms=ms, plain_ms=plain,
                bound_ms=1e3 * max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops
                else "operations", bytes=nbytes)


def conformance_specs(SweepSpec, policies):
    conf = SweepSpec(
        policies=policies,
        scenarios=("closed_mixed", "closed_read_heavy", "closed_write_heavy",
                   "closed_low_mlp"),
        densities=DENSITIES, reqs=96, seed=2, mode="closed")
    multi = SweepSpec(policies=policies,
                      scenarios=("closed_multirank", "closed_mixed"),
                      densities=(32,), reqs=400, seed=7, mode="closed",
                      n_ranks=2, n_channels=2)
    subs = [SweepSpec(policies=("sarp_pb", "dsarp", "hira", "sarp_ab",
                                "ideal"),
                      scenarios=("closed_subarray_storm",
                                 "closed_subarray_locality"),
                      densities=(8, 32), reqs=400, seed=3, mode="closed",
                      n_subarrays=s) for s in (1, 4)]
    return [("conformance", conf), ("multirank", multi),
            ("subarray_s1", subs[0]), ("subarray_s4", subs[1])]


def open_conformance_specs(SweepSpec, policies):
    """The grids of `conformance_specs` in open form: open scenarios, the
    spec's default mode."""
    conf = SweepSpec(
        policies=policies,
        scenarios=("mixed", "read_heavy", "write_burst_draining",
                   "bank_camping"),
        densities=DENSITIES, reqs=96, seed=2)
    multi = SweepSpec(policies=policies,
                      scenarios=("mixed", "write_burst_draining"),
                      densities=(32,), reqs=400, seed=7, n_ranks=2,
                      n_channels=2)
    subs = [SweepSpec(policies=("sarp_pb", "dsarp", "hira", "sarp_ab",
                                "ideal"),
                      scenarios=("subarray_conflict_adversarial",
                                 "row_buffer_friendly"),
                      densities=(8, 32), reqs=400, seed=3, n_subarrays=s)
            for s in (1, 4)]
    return [("open_conformance", conf), ("open_multirank", multi),
            ("open_subarray_s1", subs[0]), ("open_subarray_s4", subs[1])]


def check_megakernel(sweep, specs):
    """Kernel vs the torch tick body on the card (plain arbiter, then
    the arbiter kernel inside the torch body) and vs numpy `batched` on
    the host; exact on every `CellResult` field."""
    out = []
    for name, spec in specs:
        t0 = time.perf_counter()
        mega = sweep(spec, "mega")
        plain = sweep(spec, "torch")
        require_equal(plain, mega, f"{name}: megakernel vs backend='torch'")
        require_equal(sweep(spec, "batched"), mega,
                      f"{name}: megakernel vs backend='batched'")
        if name.endswith("conformance"):
            require_equal(sweep(spec, "torch", arbiter="cuda"), plain,
                          f"{name}: torch body with the arbiter kernel")
        if not all(c.finished for c in mega.cells):
            raise AssertionError(f"{name}: unfinished cells")
        out.append(dict(grid=name, mode=spec.mode, cells=len(mega.cells),
                        differing=0,
                        seconds=round(time.perf_counter() - t0, 3)))
    return out


def check_wide(torch, sweep, SweepSpec):
    """Both megakernels on 128-bank cells - DDR4's 16 banks a rank, 4
    ranks, 2 channels; bank sets of two words, the wide instantiation -
    against their plain versions on the same device inputs, and through
    `sweep()` against `batched` on the host. The demand is long enough
    for all-bank refreshes to fire."""
    from repro_torch.core.sweep.engine import _Grid
    from repro_torch.kernels import sweep_megakernel as mega
    out = []
    for mode, scn, reqs in (("closed", "closed_mixed", 2000),
                            ("open", "mixed", 1200)):
        t0 = time.perf_counter()
        spec = SweepSpec(policies=ONE_PER_KIND, scenarios=(scn,),
                         densities=(32,), reqs=reqs, seed=4, mode=mode,
                         n_banks=16, n_ranks=4, n_channels=2)
        grid = _Grid(spec, stack_streams=False)
        cfg, _, params, scn_t, streams, counts = mega.device_inputs(
            grid, "cuda")
        if mode == "closed":
            got = mega.mega_closed_cells(cfg, params, scn_t, streams,
                                         counts)[:2]
            want = mega._plain_closed_cells(cfg, params, scn_t, streams,
                                            counts)[:2]
        else:
            got = mega.mega_open_cells(cfg, params, scn_t, streams,
                                       counts)[:1]
            want = mega._plain_open_cells(cfg, params, scn_t, streams,
                                          counts)[:1]
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"128-bank {mode} megakernel differs from "
                                 f"its plain version: max abs {err}")
        res = sweep(spec, "mega")
        require_equal(sweep(spec, "batched"), res,
                      f"128-bank {mode}: megakernel vs backend='batched'")
        refab = sum(c.refreshes_ab for c in res.cells)
        if cfg.B != 128 or refab == 0 or not all(c.finished
                                                 for c in res.cells):
            raise AssertionError(f"128-bank {mode} grid: B={cfg.B}, "
                                 f"{refab} all-bank refreshes")
        out.append(dict(mode=mode, banks=cfg.B, cells=len(res.cells),
                        reqs=reqs, max_abs_err=err, refreshes_ab=refab,
                        seconds=round(time.perf_counter() - t0, 3)))
    return out


# ------------------------------------------------------------- phase 4
def paper_phase(sweep, SweepSpec, np):
    runs = []
    for s in FIG_SEEDS:
        spec = SweepSpec(policies=FIG3_POLICIES,
                         scenarios=CLOSED_FIG_SCENARIOS, densities=DENSITIES,
                         reqs=2000, seed=s, mode="closed")
        t0 = time.perf_counter()
        res = sweep(spec)                       # default backend, on the card
        secs = time.perf_counter() - t0
        if res.backend != "mega":
            raise AssertionError("default backend is not the megakernel")
        if not all(c.finished for c in res.cells):
            raise AssertionError(f"paper grid seed {s}: unfinished cells")
        runs.append((spec, res, secs))
    loss = {}
    for p in FIG3_POLICIES:
        for d in DENSITIES:
            vals = [1.0 - res.get(p, sc, d).weighted_speedup_vs(
                res.get("ideal", sc, d))
                for _, res, _ in runs for sc in CLOSED_FIG_SCENARIOS]
            loss[f"{p}@{d}"] = float(np.mean(vals))
    for d in DENSITIES:
        if loss[f"ideal@{d}"] != 0.0:
            raise AssertionError("ideal has a loss against itself")
        if not all(np.isfinite(loss[f"{p}@{d}"]) for p in FIG3_POLICIES):
            raise AssertionError("non-finite weighted-speedup loss")
    # figure 1's ordering at the highest density: all-bank refresh costs
    # more than per-bank refresh, and both cost something
    if not loss["ref_ab@32"] > loss["ref_pb@32"] > 0.0:
        raise AssertionError(f"refresh-loss ordering broken: {loss}")
    max_ticks = [max(int(round(max(c.core_finish) / spec.dt_ns))
                     for c in r.cells) for spec, r, _ in runs]
    return runs[0], dict(
        phase="paper", cells=len(runs[0][1].cells),
        seeds=list(FIG_SEEDS), reqs=2000, max_ticks_per_cell=max_ticks,
        mega_seconds=[round(s, 4) for _, _, s in runs],
        mega_stage_seconds=[r.seconds for _, r, _ in runs],
        loss_vs_ideal=loss)


def paper_arbiter_phase(sweep, spec, mega_res):
    """The paper grid (seed 1) on the numpy `batched` backend with the
    arbiter kernel as its scoring step, equal to the megakernel's."""
    t0 = time.perf_counter()
    host = sweep(spec, "batched", arbiter="cuda")
    secs = time.perf_counter() - t0
    require_equal(host, mega_res, "paper grid: batched+arbiter kernel vs "
                                  "mega")
    return dict(phase="paper_batched_arbiter", cells=len(host.cells),
                arbiter_shape=[len(host.cells), ARBITER_B],
                seconds=round(secs, 3))


# ------------------------------------------------------------- phase 5
def ladder_spec(SweepSpec, make_closed_demand, policies, n_scen, first=0):
    scen = []
    for i in range(first, n_scen):
        name = MEGA_BASE_SCENARIOS[i % len(MEGA_BASE_SCENARIOS)]
        d = make_closed_demand(name, reqs=32, seed=1000 + i)
        scen.append(dataclasses.replace(d, name=f"{name}#s{i}"))
    return SweepSpec(policies=policies, scenarios=tuple(scen),
                     densities=DENSITIES, reqs=32, seed=0, mode="closed")


def full_phase(sweep, SweepSpec, make_closed_demand, policies):
    t0 = time.perf_counter()
    spec = ladder_spec(SweepSpec, make_closed_demand, policies,
                       LADDER_SCENARIOS)
    t_spec = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sweep(spec, backend="mega")
    total = time.perf_counter() - t0
    n = len(res.cells)
    if n != len(policies) * LADDER_SCENARIOS * len(DENSITIES):
        raise AssertionError(f"ladder rung has {n} cells")
    if not all(c.finished for c in res.cells):
        raise AssertionError("ladder rung: unfinished cells")
    tail = ladder_spec(SweepSpec, make_closed_demand, policies,
                       LADDER_SCENARIOS, first=LADDER_SCENARIOS - 24)
    ref = sweep(tail, "batched")
    bad = [c for c in ref.cells
           if res.get(c.policy, c.scenario, c.density_gb) != c]
    if bad:
        raise AssertionError(f"ladder rung: {len(bad)} of {len(ref.cells)} "
                             f"tail cells differ from batched: {bad[0]}")
    return spec, res, dict(
        phase="full", rung="1e5", cells=n, scenarios=LADDER_SCENARIOS,
        reqs=32, demand_seconds=round(t_spec, 3),
        grid_seconds=round(res.seconds["grid"], 3),
        device_run_seconds=round(res.seconds["run"], 3),
        finalize_seconds=round(res.seconds["finalize"], 3),
        sweep_seconds=round(total, 3), cells_per_second=n / total,
        tail_cells_checked=len(ref.cells))


def full_arbiter_phase(sweep, spec, mega_res):
    """The same 100128 cells on the host-driven torch tick body with the
    arbiter kernel as its scoring step (one launch a tick at
    [100128, 8]), every cell equal to the megakernel's."""
    t0 = time.perf_counter()
    res = sweep(spec, "torch", arbiter="cuda")
    secs = time.perf_counter() - t0
    require_equal(res, mega_res, "ladder rung: torch body + arbiter "
                                 "kernel vs mega")
    return dict(phase="full_torch_arbiter", cells=len(res.cells),
                arbiter_shape=[len(res.cells), ARBITER_B],
                cells_equal_to_mega=len(res.cells),
                sweep_seconds=round(secs, 3))


def time_megakernel(torch, spec):
    """The kernel and its plain version at the phase-5 shape, on the same
    device inputs; the two results must be equal."""
    from repro_torch.core.sweep.engine import _Grid
    from repro_torch.kernels import sweep_megakernel as mega
    grid = _Grid(spec, stack_streams=False)
    cfg, _, params, scn, streams, nreq = mega.device_inputs(grid, "cuda")
    out = {}

    def run(_):
        out["k"] = mega.mega_closed_cells(cfg, params, scn, streams, nreq)
    ms = time_cuda(torch, run, 3)
    stats, cf, ticks = out["k"]
    t0 = time.perf_counter()
    p_stats, p_cf, _ = mega._plain_closed_cells(cfg, params, scn, streams,
                                                nreq)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = max(int((stats.long() - p_stats.long()).abs().max()),
              int((cf.long() - p_cf.long()).abs().max()))
    if not (torch.equal(stats, p_stats) and torch.equal(cf, p_cf)):
        raise AssertionError(f"megakernel differs from its plain version "
                             f"at the full shape: max abs {err}")
    n = params.shape[0]
    tk = ticks.long()
    cell_ticks, max_ticks = int(tk.sum()), int(tk.max())
    # bytes: every input read once, every output written once
    nbytes = 4 * (params.numel() + scn.numel() + nreq.numel()
                  + sum(v.numel() for v in streams.values())
                  + stats.numel() + cf.numel() + ticks.numel())
    # operations: counted from the kernel's source statement by statement
    # (`closed_operations` spells the sum out), for the ticks, serves and
    # refreshes this run's data needed
    ops = mega.closed_operations(cfg, params, stats, ticks)
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=1e3 * max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops
                else "operations", cells=n, cell_ticks=cell_ticks,
                max_ticks_per_cell=max_ticks,
                cell_ticks_per_second=cell_ticks / (ms / 1e3),
                operations=ops, ops_per_cell_tick=ops / cell_ticks,
                io_bytes=nbytes)


# ------------------------------------------------------------- phase 6
def open_grid_phase(sweep, SweepSpec, np):
    """The reference's open grid through the default entry point (kernel
    A2 on the card), equal to `batched` on the host; the open-loop
    metric, latency speedup against the no-refresh ideal, must be finite
    and at most 1 for every policy."""
    spec = SweepSpec(policies=GRID_POLICIES, scenarios=GRID_SCENARIOS,
                     densities=DENSITIES, reqs=OPEN_REQS, seed=0)
    if spec.mode != "open":
        raise AssertionError("SweepSpec's default mode is not 'open'")
    t0 = time.perf_counter()
    res = sweep(spec)                           # default backend, on the card
    secs = time.perf_counter() - t0
    if res.backend != "mega" or len(res.cells) != 192:
        raise AssertionError("open grid: wrong backend or cell count")
    if not all(c.finished and c.mode == "open" for c in res.cells):
        raise AssertionError("open grid: unfinished cells")
    t0 = time.perf_counter()
    host = sweep(spec, "batched")
    host_secs = time.perf_counter() - t0
    require_equal(host, res, "open grid: megakernel vs backend='batched'")
    speed = {}
    for p in GRID_POLICIES:
        for d in DENSITIES:
            v = [res.get(p, sc, d).latency_speedup_vs(res.get("ideal", sc, d))
                 for sc in GRID_SCENARIOS]
            speed[f"{p}@{d}"] = float(np.mean(v))
    if not all(np.isfinite(v) and 0.0 < v <= 1.0 + 1e-12
               for v in speed.values()) or any(
            speed[f"ideal@{d}"] != 1.0 for d in DENSITIES):
        raise AssertionError(f"open grid: latency speedups {speed}")
    max_ticks = max(int(round(c.makespan / spec.dt_ns)) for c in res.cells)
    return spec, res, dict(
        phase="open_grid", cells=len(res.cells), reqs=OPEN_REQS, seed=0,
        sweep_seconds=round(secs, 4), stage_seconds=res.seconds,
        batched_seconds=round(host_secs, 3), max_ticks_per_cell=max_ticks,
        latency_speedup_vs_ideal=speed)


def open_arbiter_phase(sweep, spec, mega_res, backend):
    """The open grid on a host-driven backend whose scoring step is the
    arbiter kernel (open form), equal to the megakernel's cells."""
    t0 = time.perf_counter()
    res = sweep(spec, backend, arbiter="cuda")
    secs = time.perf_counter() - t0
    require_equal(res, mega_res, f"open grid: {backend} + arbiter kernel "
                                 f"vs mega")
    return dict(phase=f"open_grid_{backend}_arbiter", cells=len(res.cells),
                arbiter_shape=[len(res.cells), ARBITER_B],
                sweep_seconds=round(secs, 3))


def open_ladder_spec(SweepSpec, make_trace, policies, n_scen, first=0):
    """The open counterpart of `ladder_spec`: the 8 grid scenarios
    cycled, each trace seed-varied and renamed."""
    scen = []
    for i in range(first, n_scen):
        name = GRID_SCENARIOS[i % len(GRID_SCENARIOS)]
        tr = make_trace(name, 8, 8, reqs=OPEN_REQS, seed=1000 + i)
        scen.append(dataclasses.replace(tr, name=f"{name}#s{i}"))
    return SweepSpec(policies=policies, scenarios=tuple(scen),
                     densities=DENSITIES, reqs=OPEN_REQS, seed=0)


def open_ladder_phase(sweep, SweepSpec, make_trace, policies):
    t0 = time.perf_counter()
    spec = open_ladder_spec(SweepSpec, make_trace, policies,
                            LADDER_SCENARIOS)
    t_spec = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sweep(spec)
    total = time.perf_counter() - t0
    n = len(res.cells)
    if n != len(policies) * LADDER_SCENARIOS * len(DENSITIES):
        raise AssertionError(f"open ladder rung has {n} cells")
    if not all(c.finished for c in res.cells):
        raise AssertionError("open ladder rung: unfinished cells")
    tail = open_ladder_spec(SweepSpec, make_trace, policies,
                            LADDER_SCENARIOS, first=LADDER_SCENARIOS - 24)
    ref = sweep(tail, "batched")
    bad = [c for c in ref.cells
           if res.get(c.policy, c.scenario, c.density_gb) != c]
    if bad:
        raise AssertionError(f"open ladder rung: {len(bad)} of "
                             f"{len(ref.cells)} tail cells differ from "
                             f"batched: {bad[0]}")
    return spec, dict(
        phase="open_ladder", rung="1e5", cells=n,
        scenarios=LADDER_SCENARIOS, reqs=OPEN_REQS,
        trace_seconds=round(t_spec, 3),
        grid_seconds=round(res.seconds["grid"], 3),
        device_run_seconds=round(res.seconds["run"], 3),
        finalize_seconds=round(res.seconds["finalize"], 3),
        sweep_seconds=round(total, 3), cells_per_second=n / total,
        tail_cells_checked=len(ref.cells))


def time_open_megakernel(torch, spec):
    """Kernel A2 and its plain version at the open ladder's shape, on
    the same device inputs; the two results must be equal."""
    from repro_torch.core.sweep.engine import _Grid
    from repro_torch.kernels import sweep_megakernel as mega
    grid = _Grid(spec, stack_streams=False)
    cfg, _, params, scn, streams, npb = mega.device_inputs(grid, "cuda")
    out = {}

    def run(_):
        out["k"] = mega.mega_open_cells(cfg, params, scn, streams, npb)
    ms = time_cuda(torch, run, 3)
    stats, ticks = out["k"]
    t0 = time.perf_counter()
    p_stats, _ = mega._plain_open_cells(cfg, params, scn, streams, npb)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = int((stats.long() - p_stats.long()).abs().max())
    if not torch.equal(stats, p_stats):
        raise AssertionError(f"open megakernel differs from its plain "
                             f"version at the full shape: max abs {err}")
    n = params.shape[0]
    tk = ticks.long()
    cell_ticks, max_ticks = int(tk.sum()), int(tk.max())
    # bytes: every input read once, every output written once
    nbytes = 4 * (params.numel() + scn.numel() + npb.numel()
                  + sum(v.numel() for v in streams.values())
                  + stats.numel() + ticks.numel())
    # operations: counted from the kernel's source (`open_operations`)
    ops = mega.open_operations(cfg, params, stats, ticks)
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=1e3 * max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops
                else "operations", cells=n, L=cfg.L, cell_ticks=cell_ticks,
                max_ticks_per_cell=max_ticks,
                cell_ticks_per_second=cell_ticks / (ms / 1e3),
                operations=ops, ops_per_cell_tick=ops / cell_ticks,
                io_bytes=nbytes)


# ------------------------------------------------------------- phase 7
# the float kernels (C paged attention, D kv_quant, E flash attention, F
# Mamba2 SSD), through `repro_torch.kernels.ops`, at the widths of models
# the repo supports: Qwen2.5-14B attention (src/repro/configs/
# qwen2_5_14b.py: 40 query heads, 8 kv heads, head 128), the paged cache's
# default page of 64 tokens (src/repro/kvcache/paged.py), and mamba2-130m
# (src/repro/configs/mamba2_130m.py: d_inner 1536 / head 64 = 24 heads,
# d_state 128, chunk 128).
QWEN_H, QWEN_HKV, QWEN_D, PAGE = 40, 8, 128, 64
DECODE_B, DECODE_MAXP = 8, 512            # 8 sequences of up to 32768 tokens
DECODE_PAGES = DECODE_B * DECODE_MAXP + 8
PREFILL_S, TRAIN_S = 4096, 512
SSD_B, SSD_S, SSD_H, SSD_P, SSD_N, SSD_CHUNK = 8, 4096, 24, 64, 128, 128
BF16_TC_FLOPS = 989e12                   # dense tensor cores, bf16

# Bars (atol, rtol) of each float kernel against its plain version on the
# card. float32: the reference's own (tests/test_kernels.py). bfloat16:
# kernel and plain version both compute in float32 and round the output
# to bfloat16 once, so they may differ by one rounding of the output, at
# most 2^-7 of its value: rtol 1e-2 admits that and no more, atol 1e-3
# only matters near zero. The reference's 2e-2 would be about twice a
# typical output at these lengths (a softmax mean over thousands of
# tokens) and could not tell a wrong kernel from a right one.
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 1e-2)}
PAGED_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-3, 1e-2)}
SSD_TOL = (5e-4, 2e-3)

# The float kernels' edge shapes, checked in the kernels phase and by the
# `gpu` tests (tests/test_torch_gpu.py reads these tables).
KV_QUANT_SHAPES = ((3, 8, 2, 16), (6, 64, 8, 128), (2, 5, 1, 12))
PAGED_CASES = (                           # b, h, hkv, d, t, maxp, lens
    (4, 10, 2, 16, 8, 4, (0, 9, 32, 1)),   # group 5, a zero length
    (2, 8, 8, 32, 16, 2, (17, 32)),        # group 1
    (3, 40, 8, 128, 64, 3, (130, 64, 1)),  # Qwen2.5-14B widths
    (2, 64, 4, 128, 64, 2, (100, 0)))      # Qwen3-MoE: group 16
FLASH_CASES = ((2, 64, 16), (1, 16, 8), (1, 256, 64), (2, 128, 128))
SSD_CASES = ((2, 64, 3, 8, 16, 16), (2, 32, 1, 64, 8, 8),   # b, s, h, p,
             (1, 256, 2, 64, 128, 128))                      # n, chunk


def dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def close(torch, got, want, atol, rtol, what):
    """Max abs difference of two tensors of one dtype and shape, held by
    `torch.testing.assert_close` (in float32, non-finite values failing)
    at `|got - want| <= atol + rtol |want|`; raises otherwise."""
    if got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} vs {want.dtype}")
    g, w = got.float(), want.float()
    torch.testing.assert_close(g, w, atol=atol, rtol=rtol,
                               msg=lambda m: f"{what}: {m}")
    return float((g - w).abs().max()) if g.numel() else 0.0


def check_kv_quant(torch, pages, q8, sc, what):
    """Kernel D's result `(q8, sc)` for `pages` against its plain version
    at the reference's bars; returns (max int8 difference, exactly
    equal)."""
    from repro_torch.kernels import kv_quant as kq
    q8r, scr = kq.kv_quant_torch(pages)
    close(torch, sc, scr, 0.0, 1e-4, f"{what}: scales")
    diff = int((q8.int() - q8r.int()).abs().max())
    deq = q8.float() * sc[:, None, :, None]
    bound = sc[:, None, :, None] * 0.51 + 1e-6
    if diff > 1 or not bool(((deq - pages.float()).abs() <= bound).all()):
        raise AssertionError(f"{what}: int8 differs by {diff} or the round "
                             f"trip exceeds 0.51 scale")
    return diff, bool(torch.equal(q8, q8r) and torch.equal(sc, scr))


def kv_quant_input(torch, g, shape, dtype):
    """Random pages of `shape` with an all-zero head and values on the
    rounding boundaries, in `dtype`."""
    x = torch.randn(shape, generator=g, device="cuda") * 3
    x[0, :, 0] = 0.0                                    # an all-zero head
    x[1, 0, 0, :4] = torch.tensor([63.5, -63.5, 0.5, 127.0])
    return x.to(dtype)


def paged_case(torch, np, b, h, hkv, d, t, maxp, lens, seed):
    """Random int8 cache pages (quantized by the plain version), a page
    table with -1 past each sequence's pages, lengths, q in float32."""
    from repro_torch.kernels import kv_quant as kq
    rs = np.random.RandomState(seed)
    n_pages = b * maxp + 2
    g = torch.Generator(device="cuda").manual_seed(seed)
    k8, ks = kq.kv_quant_torch(torch.randn((n_pages, t, hkv, d),
                                           generator=g, device="cuda"))
    v8, vs = kq.kv_quant_torch(torch.randn((n_pages, t, hkv, d),
                                           generator=g, device="cuda"))
    table = rs.permutation(n_pages)[:b * maxp].reshape(b, maxp)
    for bi, n in enumerate(lens):
        table[bi, (n + t - 1) // t:] = -1
    q = torch.randn((b, h, d), generator=g, device="cuda")
    return (q, k8, v8, ks, vs,
            torch.from_numpy(table.astype(np.int32)).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def check_float_kernels(torch, np):
    """C, D, E, F against their plain versions on the card at small edge
    shapes: ragged lengths, a zero-length sequence, -1 table padding, GQA
    groups 1, 5 and 16, S=64 and 16 for flash, both input types."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_quant as kq
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import refresh_paged_attention as rpa
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    diff, exact = 0, True
    for dtype in (torch.float32, torch.bfloat16):
        for shape in KV_QUANT_SHAPES:
            x = kv_quant_input(torch, g, shape, dtype)
            d_, e_ = check_kv_quant(torch, x, *kq.kv_quant(x),
                                    f"kv_quant {dtype} {shape}")
            diff, exact = max(diff, d_), exact and e_
    out["kv_quant"] = {"max_abs_err_int8": diff, "exact": exact}
    errs = {}
    for (b, h, hkv, d, t, maxp, lens) in PAGED_CASES:
        q, *cache = paged_case(torch, np, b, h, hkv, d, t, maxp, lens,
                               seed=b * 10 + h)
        for dtype in (torch.float32, torch.bfloat16):
            qd = q.to(dtype)
            got = rpa.refresh_paged_attention(qd, *cache, page_size=t)
            want = rpa.paged_attention_torch(qd, *cache, page_size=t)
            key = f"paged {dtype} B{b} H{h} Hkv{hkv} D{d} T{t}"
            errs[key] = close(torch, got, want,
                              *PAGED_TOL[dtype_name(dtype)], key)
            if any(n == 0 for n in lens) and bool(
                    got[[i for i, n in enumerate(lens) if n == 0]].any()):
                raise AssertionError(f"{key}: a zero-length sequence got "
                                     f"non-zero output")
    out["paged_attention"] = errs
    errs = {}
    for (bh, s, d) in FLASH_CASES:
        q, k, v = (torch.randn((bh, s, d), generator=g, device="cuda")
                   for _ in range(3))
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
                got = fa.flash_attention(qd, kd, vd, causal=causal)
                want = fa.flash_attention_torch(qd, kd, vd, causal=causal)
                key = f"flash {dtype} BH{bh} S{s} D{d} causal={causal}"
                errs[key] = close(torch, got, want,
                                  *FLASH_TOL[dtype_name(dtype)], key)
    out["flash_attention"] = errs
    errs = {}
    for (b, s, h, p, n, chunk) in SSD_CASES:
        args = ssd_inputs(torch, g, b, s, h, p, n)
        key = f"ssd B{b} S{s} H{h} P{p} N{n} chunk{chunk}"
        errs[key] = close(torch, ssd.mamba2_ssd(*args, chunk=chunk),
                          ssd.mamba2_ssd_torch(*args, chunk=chunk),
                          *SSD_TOL, key)
    out["mamba2_ssd"] = errs
    return out


def ssd_inputs(torch, g, b, s, h, p, n):
    """x, dt (post-softplus, > 0), A (< 0), B, C as the reference test
    draws them."""
    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    return (rnd(b, s, h, p), rnd(b, s, h).abs() * 0.1 + 0.01,
            -rnd(h).abs() - 0.1, rnd(b, s, n), rnd(b, s, n))


def paged_decode_path(torch, np):
    """Qwen2.5-14B decode over a paged int8 cache: f32 K/V pages
    [4104, 64, 8, 128] quantized by `ops.kv_quant` (D), then 8 sequences
    of up to 32768 tokens (one full, one ragged, -1 past each sequence's
    pages) attended by `ops.refresh_paged_attention` (C), q in float32
    and in bfloat16. Held against the plain versions and against
    `ops.paged_attention_serial`."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import refresh_paged_attention as rpa
    rs = np.random.RandomState(0)
    full = DECODE_MAXP * PAGE
    lens = rs.randint(1, full + 1, DECODE_B)
    lens[0], lens[1] = full, full - 37                 # full, and ragged
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (DECODE_PAGES, PAGE, QWEN_HKV, QWEN_D)
    kp = torch.randn(shape, generator=g, device="cuda")
    vp = torch.randn(shape, generator=g, device="cuda")
    table = rs.permutation(DECODE_PAGES)[:DECODE_B * DECODE_MAXP].reshape(
        DECODE_B, DECODE_MAXP)
    for bi, n in enumerate(lens):
        table[bi, (n + PAGE - 1) // PAGE:] = -1
    table = torch.from_numpy(table.astype(np.int32)).cuda()
    seq_lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    q = torch.randn((DECODE_B, QWEN_H, QWEN_D), generator=g, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k8, ks = ops.kv_quant(kp)
    v8, vs = ops.kv_quant(vp)
    outs = {dt: ops.refresh_paged_attention(q.to(dt), k8, v8, ks, vs, table,
                                            seq_lens, page_size=PAGE)
            for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    (kd, ke), (vd, ve) = (check_kv_quant(torch, *a, f"decode kv_quant {n}")
                          for n, a in (("K", (kp, k8, ks)), ("V", (vp, v8, vs))))
    kq_diff, kq_exact = max(kd, vd), ke and ve
    cache = (k8, v8, ks, vs, table, seq_lens)
    errs = {}
    for dt, got in outs.items():
        want = rpa.paged_attention_torch(q.to(dt), *cache, page_size=PAGE)
        errs[str(dt)] = close(torch, got, want, *PAGED_TOL[dtype_name(dt)],
                              f"decode paged attention {dt}")
    serial = ops.paged_attention_serial(q, *cache, page_size=PAGE)
    serial_err = close(torch, outs[torch.float32], serial, 2e-2, 2e-2,
                       "decode: fused vs paged_attention_serial")
    valid_pages = int(((seq_lens.long() + PAGE - 1) // PAGE).sum())
    return (kp, q, cache, valid_pages), dict(
        phase="ops_paged_decode", model="Qwen2.5-14B decode",
        pages=list(shape), seq_lens=lens.tolist(), max_pages=DECODE_MAXP,
        valid_pages=valid_pages,
        int8_cache_bytes=2 * DECODE_PAGES * PAGE * QWEN_HKV * QWEN_D,
        kv_quant_max_abs_err_int8=kq_diff, kv_quant_exact=kq_exact,
        max_abs_err=errs, vs_serial_max_abs_err=serial_err,
        seconds=round(secs, 4))


def prefill_flash_path(torch, np):
    """Qwen2.5-14B prefill of one 4096-token prompt: q/k/v [40, 4096, 128]
    (kv GQA-expanded), causal, through `ops.flash_attention` (E) in
    bfloat16 and float32; then one forward and backward of
    `ops.flash_attention_trainable` at S=512, its gradients held against
    autograd through the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = [torch.randn((QWEN_H, PREFILL_S, QWEN_D), generator=g,
                       device="cuda") for _ in range(3)]
    errs, secs = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        args = [x.to(dt) for x in qkv]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ops.flash_attention(*args, causal=True)
        torch.cuda.synchronize()
        secs[str(dt)] = round(time.perf_counter() - t0, 4)
        want = fa.flash_attention_torch(*args, causal=True)
        errs[str(dt)] = close(torch, got, want, *FLASH_TOL[dtype_name(dt)],
                              f"prefill flash {dt}")
        del got, want
    small = [x[:, :TRAIN_S].contiguous() for x in qkv]
    kern = [x.clone().requires_grad_() for x in small]
    (ops.flash_attention_trainable(*kern, True) ** 2).sum().backward()
    plain = [x.clone().requires_grad_() for x in small]
    (fa.flash_attention_torch(*plain, causal=True) ** 2).sum().backward()
    grad_err = max(close(torch, a.grad, b.grad, 1e-4, 1e-4,
                         f"trainable flash gradient {i}")
                   for i, (a, b) in enumerate(zip(kern, plain)))
    return qkv, dict(
        phase="ops_prefill_flash", model="Qwen2.5-14B prefill",
        shape=[QWEN_H, PREFILL_S, QWEN_D], causal=True, max_abs_err=errs,
        seconds=secs, trainable_shape=[QWEN_H, TRAIN_S, QWEN_D],
        trainable_grad_max_abs_err=grad_err)


def ssd_path(torch, np):
    """mamba2-130m's SSD scan over a batch of 8 sequences of 4096 tokens:
    x [8, 4096, 24, 64], B/C [8, 4096, 128], chunk 128, through
    `ops.mamba2_ssd` (F), held against the plain version."""
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(2)
    args = ssd_inputs(torch, g, SSD_B, SSD_S, SSD_H, SSD_P, SSD_N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = ops.mamba2_ssd(*args, chunk=SSD_CHUNK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    err = close(torch, y, ssd.mamba2_ssd_torch(*args, chunk=SSD_CHUNK),
                *SSD_TOL, "ssd at mamba2-130m widths")
    return args, dict(phase="ops_ssd", model="mamba2-130m",
                      x=[SSD_B, SSD_S, SSD_H, SSD_P], d_state=SSD_N,
                      chunk=SSD_CHUNK, max_abs_err=err,
                      seconds=round(secs, 4))


def bound(nbytes, ops, peak):
    """(bound ms, what bounds it) for `nbytes` moved and `ops` done at
    `peak` operations a second."""
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                       else "operations")


def time_float_kernels(torch, dec, qkv, ssd_args):
    """C, D, E, F at their paths' shapes (CUDA events), beside their plain
    versions, their bounds and, for E, `scaled_dot_product_attention` -
    the one PyTorch call that computes the same function (timed here,
    never called by the port). C also reports `paged_attention_serial`."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_quant as kq
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops
    from repro_torch.kernels import refresh_paged_attention as rpa
    out = {}
    kp, q, cache, valid_pages = dec
    # f32 pages read once, int8 pages and f32 scales written once
    nbytes = 5 * kp.numel() + 4 * kp.shape[0] * kp.shape[2]
    ms, b_by = bound(nbytes, 0, 1.0)
    out["kv_quant"] = dict(
        shape=list(kp.shape), dtype="float32",
        ms=time_cuda(torch, lambda i: kq.kv_quant(kp), 20),
        plain_ms=time_cuda(torch, lambda i: kq.kv_quant_torch(kp), 5),
        bound_ms=ms, bound_by=b_by, bytes=nbytes)
    # the int8 K and V of each sequence's first seq_len rows, the valid
    # pages' scales and table entries, and the lengths read once; q read
    # and the output written once
    rows = int(cache[-1].long().sum()) * QWEN_HKV * QWEN_D
    nbytes = (2 * rows + 2 * 4 * valid_pages * QWEN_HKV + 4 * valid_pages
              + 4 * DECODE_B + 2 * 4 * q.numel())
    ms, b_by = bound(nbytes, 0, 1.0)
    out["paged_attention"] = dict(
        q=list(q.shape), valid_pages=valid_pages, dtype="float32",
        ms=time_cuda(torch, lambda i: rpa.refresh_paged_attention(
            q, *cache, page_size=PAGE), 20),
        plain_ms=time_cuda(torch, lambda i: rpa.paged_attention_torch(
            q, *cache, page_size=PAGE), 5),
        serial_ms=time_cuda(torch, lambda i: ops.paged_attention_serial(
            q, *cache, page_size=PAGE), 5),
        bound_ms=ms, bound_by=b_by, bytes=nbytes)
    fl = fa.operations(QWEN_H, PREFILL_S, PREFILL_S, QWEN_D, True)
    for dt, peak in ((torch.bfloat16, BF16_TC_FLOPS),
                     (torch.float32, FP32_FLOPS)):
        a = [x.to(dt) for x in qkv]
        # q, k, v read once and the output written once
        ms, b_by = bound(4 * a[0].numel() * a[0].element_size(), fl, peak)
        out[f"flash_attention_{dtype_name(dt)}"] = dict(
            shape=list(a[0].shape), causal=True, operations=fl,
            ms=time_cuda(torch, lambda i: fa.flash_attention(
                *a, causal=True), 5),
            plain_ms=time_cuda(torch, lambda i: fa.flash_attention_torch(
                *a, causal=True), 3),
            # [1, H, S, D]: the layout SDPA's fused backends take
            library_ms=time_cuda(torch, lambda i:
                                 F.scaled_dot_product_attention(
                                     *[x[None] for x in a], is_causal=True),
                                 10),
            bound_ms=ms, bound_by=b_by)
    b, s, h, p = ssd_args[0].shape
    fl = ssd.operations(b, s, h, p, SSD_N, SSD_CHUNK)
    nbytes = 4 * (2 * ssd_args[0].numel() + ssd_args[1].numel() + h
                  + 2 * ssd_args[3].numel())
    ms, b_by = bound(nbytes, fl, FP32_FLOPS)
    out["mamba2_ssd"] = dict(
        x=[b, s, h, p], operations=fl,
        ms=time_cuda(torch, lambda i: ssd.mamba2_ssd(*ssd_args,
                                                     chunk=SSD_CHUNK), 5),
        plain_ms=time_cuda(torch, lambda i: ssd.mamba2_ssd_torch(
            *ssd_args, chunk=SSD_CHUNK), 3),
        bound_ms=ms, bound_by=b_by, bytes=nbytes)
    return out


# ---------------------------------------------------------------- main
def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False - this "
              "check needs an NVIDIA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core.policy import list_policies
    from repro_torch.core.refresh.scenarios import (make_closed_demand,
                                                    make_trace)
    from repro_torch.core.sweep import SweepSpec, sweep
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_quant as kq
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import refresh_paged_attention as rpa
    from repro_torch.kernels import sweep_arbiter as arb
    from repro_torch.kernels import sweep_megakernel as mega
    # the plain versions are held in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build (from the sources in this checkout, into build/)
    _build.load()
    regs = [ln.strip() for ln in _build.info["log"].splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(_build.info["seconds"], 3),
          "reused": _build.info["reused"], "library": os.path.relpath(
              _build.info["path"], HERE), "ptxas": regs})

    # 3. kernels against their plain versions
    policies = tuple(list_policies())
    arb_err = check_arbiter(torch, np)
    grids = check_megakernel(sweep, conformance_specs(SweepSpec, policies))
    open_grids = check_megakernel(sweep,
                                  open_conformance_specs(SweepSpec, policies))
    wide = check_wide(torch, sweep, SweepSpec)
    flt = check_float_kernels(torch, np)
    emit({"phase": "kernels", "arbiter": {
        "G": ARBITER_G, "B": ARBITER_B, "forms": ["closed", "open"],
        "max_abs_err": arb_err}, "megakernel": grids,
        "open_megakernel": open_grids, "wide_128_banks": wide,
        "tolerance": 0, "float_kernels": flt, "float_tolerances": {
            "flash": FLASH_TOL, "paged_attention": PAGED_TOL,
            "mamba2_ssd": SSD_TOL, "kv_quant": "scales rtol 1e-4, int8 "
            "within 1, |x - q s| <= 0.51 s"}})

    # 4 - 7. the main paths, each with every launch counter from zero
    paths = {}
    counters = {"mega": (mega, "LAUNCHES"),
                "mega_open": (mega, "OPEN_LAUNCHES"),
                "arbiter": (arb, "LAUNCHES"), "kv_quant": (kq, "LAUNCHES"),
                "paged_attention": (rpa, "LAUNCHES"),
                "flash_attention": (fa, "LAUNCHES"),
                "mamba2_ssd": (ssd, "LAUNCHES")}

    def drive(label, expects, fn, *args):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        out = fn(*args)
        paths[label] = {k: getattr(mod, attr)
                        for k, (mod, attr) in counters.items()}
        for name in expects.split("+"):
            if paths[label][name] <= 0:
                raise AssertionError(f"path {label} never launched the "
                                     f"{name} kernel")
        return out

    (paper_spec, paper_res, _), paper = drive(
        "paper_mega", "mega", paper_phase, sweep, SweepSpec, np)
    emit(dict(paper, launches=paths["paper_mega"]))
    emit(dict(drive("paper_batched_arbiter", "arbiter", paper_arbiter_phase,
                    sweep, paper_spec, paper_res),
              launches=paths["paper_batched_arbiter"]))
    full_spec, full_res, full = drive(
        "ladder_mega", "mega", full_phase, sweep, SweepSpec,
        make_closed_demand, policies)
    emit(dict(full, launches=paths["ladder_mega"]))
    emit(dict(drive("ladder_torch_arbiter", "arbiter", full_arbiter_phase,
                    sweep, full_spec, full_res),
              launches=paths["ladder_torch_arbiter"]))
    del full_res, paper_res
    open_spec, open_res, og = drive("open_grid_mega", "mega_open",
                                    open_grid_phase, sweep, SweepSpec, np)
    emit(dict(og, launches=paths["open_grid_mega"]))
    for backend in ("batched", "torch"):
        label = f"open_grid_{backend}_arbiter"
        emit(dict(drive(label, "arbiter", open_arbiter_phase, sweep,
                        open_spec, open_res, backend),
                  launches=paths[label]))
    del open_res
    ladder_spec_open, ol = drive("open_ladder_mega", "mega_open",
                                 open_ladder_phase, sweep, SweepSpec,
                                 make_trace, policies)
    emit(dict(ol, launches=paths["open_ladder_mega"]))
    dec_in, dec = drive("ops_paged_decode", "kv_quant+paged_attention",
                        paged_decode_path, torch, np)
    emit(dict(dec, launches=paths["ops_paged_decode"]))
    qkv, pre = drive("ops_prefill_flash", "flash_attention",
                     prefill_flash_path, torch, np)
    emit(dict(pre, launches=paths["ops_prefill_flash"]))
    ssd_args, sp = drive("ops_ssd", "mamba2_ssd", ssd_path, torch, np)
    emit(dict(sp, launches=paths["ops_ssd"]))
    by_path = {k: {p: n[k] for p, n in paths.items()} for k in counters}

    # timings at the main-path shapes (not counted as launches)
    ta = time_arbiter(torch, np, ARBITER_G)
    ta_paper = time_arbiter(torch, np, len(FIG3_POLICIES)
                            * len(CLOSED_FIG_SCENARIOS) * len(DENSITIES))
    tm = time_megakernel(torch, full_spec)
    to = time_open_megakernel(torch, ladder_spec_open)
    tf = time_float_kernels(torch, dec_in, qkv, ssd_args)
    emit({"phase": "timing", "arbiter": ta, "arbiter_paper_shape": ta_paper,
          "megakernel": tm, "open_megakernel": to, **tf,
          "seconds_total": round(time.perf_counter() - t_start, 1)})
    fl_bf, fl_32 = tf["flash_attention_bfloat16"], tf["flash_attention_float32"]
    emit({"kernels": [
        {"name": "sweep_mega_closed_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sweep_megakernel.cu",
         "replaces": "src/repro/kernels/sweep_megakernel.py:248",
         "launches": sum(by_path["mega"].values()),
         "launches_by_path": by_path["mega"],
         "timed_at": f"{tm['cells']} cells (path ladder_mega)",
         "max_abs_err": tm["max_abs_err"],
         "ms": tm["ms"], "plain_ms": tm["plain_ms"],
         "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
         "library_ms": None},
        {"name": "sweep_mega_open_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sweep_megakernel_open.cu",
         "replaces": "src/repro/kernels/sweep_megakernel.py:269",
         "launches": sum(by_path["mega_open"].values()),
         "launches_by_path": by_path["mega_open"],
         "timed_at": f"{to['cells']} cells (path open_ladder_mega)",
         "max_abs_err": to["max_abs_err"],
         "ms": to["ms"], "plain_ms": to["plain_ms"],
         "bound_ms": to["bound_ms"], "bound_by": to["bound_by"],
         "library_ms": None},
        {"name": "sweep_arbiter_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sweep_arbiter.cu",
         "replaces": "src/repro/kernels/sweep_arbiter.py:96",
         "launches": sum(by_path["arbiter"].values()),
         "launches_by_path": by_path["arbiter"],
         "timed_at": f"[{ta['G']}, {ta['B']}] planes (path "
                     f"ladder_torch_arbiter); not on the backend='mega' "
                     f"paths, which score inside the megakernel",
         "max_abs_err": arb_err,
         "ms": ta["ms"], "plain_ms": ta["plain_ms"],
         "bound_ms": ta["bound_ms"], "bound_by": ta["bound_by"],
         "library_ms": None},
        {"name": "paged_attention_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/refresh_paged_attention.cu",
         "replaces": "src/repro/kernels/refresh_paged_attention.py:117",
         "launches": sum(by_path["paged_attention"].values()),
         "launches_by_path": by_path["paged_attention"],
         "timed_at": f"q {tf['paged_attention']['q']} float32 over "
                     f"{tf['paged_attention']['valid_pages']} valid int8 "
                     f"pages (path ops_paged_decode)",
         "max_abs_err": dec["max_abs_err"]["torch.float32"],
         "ms": tf["paged_attention"]["ms"],
         "plain_ms": tf["paged_attention"]["plain_ms"],
         "serial_ms": tf["paged_attention"]["serial_ms"],
         "bound_ms": tf["paged_attention"]["bound_ms"],
         "bound_by": tf["paged_attention"]["bound_by"],
         "library_ms": None,
         "library_note": "no PyTorch call attends over an int8 paged cache; "
                         "serial_ms is ops.paged_attention_serial"},
        {"name": "kv_quant_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kv_quant.cu",
         "replaces": "src/repro/kernels/kv_quant.py:29",
         "launches": sum(by_path["kv_quant"].values()),
         "launches_by_path": by_path["kv_quant"],
         "timed_at": f"pages {tf['kv_quant']['shape']} float32 (path "
                     f"ops_paged_decode)",
         "max_abs_err": dec["kv_quant_max_abs_err_int8"],
         "exact": dec["kv_quant_exact"],
         "ms": tf["kv_quant"]["ms"], "plain_ms": tf["kv_quant"]["plain_ms"],
         "bound_ms": tf["kv_quant"]["bound_ms"],
         "bound_by": tf["kv_quant"]["bound_by"], "library_ms": None,
         "library_note": "no PyTorch call quantizes with a scale per "
                         "(page, head)"},
        {"name": "flash_attention_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:80",
         "launches": sum(by_path["flash_attention"].values()),
         "launches_by_path": by_path["flash_attention"],
         "timed_at": f"{fl_bf['shape']} bfloat16, causal (path "
                     f"ops_prefill_flash); float32 in the f32_* keys",
         "max_abs_err": pre["max_abs_err"]["torch.bfloat16"],
         "ms": fl_bf["ms"], "plain_ms": fl_bf["plain_ms"],
         "bound_ms": fl_bf["bound_ms"], "bound_by": fl_bf["bound_by"],
         "library_ms": fl_bf["library_ms"],
         "library_call": "torch.nn.functional.scaled_dot_product_attention"
                         "(is_causal=True)",
         "f32_max_abs_err": pre["max_abs_err"]["torch.float32"],
         "f32_ms": fl_32["ms"], "f32_plain_ms": fl_32["plain_ms"],
         "f32_bound_ms": fl_32["bound_ms"],
         "f32_library_ms": fl_32["library_ms"]},
        {"name": "mamba2_ssd_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
         "replaces": "src/repro/kernels/mamba2_ssd.py:72",
         "launches": sum(by_path["mamba2_ssd"].values()),
         "launches_by_path": by_path["mamba2_ssd"],
         "timed_at": f"x {tf['mamba2_ssd']['x']} float32, chunk "
                     f"{SSD_CHUNK} (path ops_ssd)",
         "max_abs_err": sp["max_abs_err"],
         "ms": tf["mamba2_ssd"]["ms"],
         "plain_ms": tf["mamba2_ssd"]["plain_ms"],
         "bound_ms": tf["mamba2_ssd"]["bound_ms"],
         "bound_by": tf["mamba2_ssd"]["bound_by"], "library_ms": None,
         "library_note": "PyTorch has no SSD scan"}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
