#!/usr/bin/env python3
"""Device check of the PyTorch/CUDA port: `python3 chip_smoke.py`.

Needs one NVIDIA GPU (written for an H100), PyTorch built for CUDA and
`nvcc`; takes no arguments; needs no network. It drives the port
(`src/repro_torch`) only — nothing of JAX, nothing of the JAX package —
and prints one JSON object a line:

  1. card     the card's name and power limit, as `nvidia-smi` gives them
              (also printed once as the raw CSV line);
  2. build    the `nvcc` build of `src/repro_torch/kernels/csrc/*.cu` from
              the sources in this checkout, with its seconds, ptxas's
              registers and spills, and the tensor-core instructions
              counted in `cuobjdump -sass` of the library (HGMMA in kernel
              E's bf16 function, HMMA in its f32 one and in kernel F; 0
              fails the run);
  3. kernels  each CUDA kernel against its plain PyTorch version on the
              card, exact (all-integer: the tolerance is 0):
              the arbiter kernel on random planes with ties and ineligible
              rows at G=100128, B=8, closed (`occ`) and open form; each
              tick-loop megakernel (closed A1, open A2) against
              `backend="torch"` on the card and `backend="batched"` on
              the host over the conformance, multirank and subarray grids
              of its mode, and over the grids that stress the kernels'
              group-of-lanes orderings (`lane_order_specs`: tie-heavy
              policies at 2 ranks x 2 channels, 40-bank cells whose lanes
              own two banks each); both megakernels on 128-bank cells (16
              banks x 4 ranks x 2 channels, their wide instantiation)
              against their plain versions on the same device inputs; the
              float kernels C (paged attention), D (kv_quant), E (flash
              attention) and F (Mamba2 SSD) against their plain versions
              at small edge shapes (a zero-length sequence, -1 table
              padding, GQA groups 1, 5 and 16, a sequence over six page
              splits with a ragged last page, pages of 128 rows; for
              flash `FLASH_CASES`: Sq != Skv, blocks of 8 to 256 rows, D
              from 4 to 128, q scaled by 8; for the SSD `SSD_CASES`: 64
              chunks, P and N not multiples of 16; both input types)
              at the bars `FLASH_TOL`, `PAGED_TOL`, `SSD_TOL` (the
              reference's in float32; one rounding of the output in
              bfloat16); kv_quant exactly, at `KV_QUANT_SHAPES` (model
              widths, rows of 24, 12 and 10 bytes, a slice past the
              register tile) on finite pages and on pages with a NaN
              slice and an inf slice; the reference's golden megakernel
              cases (`tests/fixtures/megakernel/`) through A1 and A2,
              equal to `batched`;
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
  8. figures  the port's figure, bench and tool scripts in this process,
              on the card (path `figures_mega`: A1 and A2): at
              `benchmarks/run.py --fast`'s arguments `fig_grids(800)`,
              `fig1`, `fig2`, `fig3`, `sweep_grid`, `closed_loop`,
              `sweep_multirank`, `sweep_subarray`, `command_trace`,
              `sweep_mega` (its regression guard: the warm megakernel
              beats `batched` on the open 8x8x3 grid), `bench_sarp_bytes`
              and `tools/check_commands_torch.py` (exit 0), every
              deterministic field equal to the reference's committed
              `results/bench/*.json`, with their times; then Figures 1
              and 3 at full load from phase 4's two paper-grid sweeps,
              equal to the reference's values to the digits of
              `FIG1_FULL_LOSS_PCT` and `FIG3_FULL_IMPR_32_PCT`, ref_ab's
              loss above ref_pb's at 32 Gb, each growing with density.
              Nothing is written into the tree.

The megakernels score inside their own tick loops and never call the
arbiter kernel: the arbiter kernel is on the `arbiter="cuda"` paths only.
The seven kernels' launch counters are set to 0 just before each of the
twelve paths and read just after it, and reported per path; a path that
did not launch its kernels fails the run. Afterwards each kernel is timed
at the shape its full-width path gives it (CUDA events) beside its plain
version and its bound (E's f32 bound and F's are the lesser of the CUDA
cores' float32 rate and three TF32 products at the TF32 tensor-core
rate, since both run 3xTF32; E beside `scaled_dot_product_attention`, C
beside `ops.paged_attention_serial` and with q in float32 and in
bfloat16; D on float32 and on bfloat16 pages); the megakernels are held
against their plain versions once more at that shape, and also at the small
grids' shapes (A1 at the paper grid, seed 1; A2 at the open reference
grid), each with its launch layout (lanes a cell, cells a block,
registers, shared memory); the arbiter kernel is also timed at the paper
path's [120, 8]. Those launches are not counted. TF32
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
# the policies whose picks tie most: first maxima over lag and demand keys,
# rank and channel round-robins
TIE_POLICIES = ("hira", "rank_aware_darp", "staggered_ab", "elastic",
                "round_robin")


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


def lane_order_specs(SweepSpec, policies):
    """Grids that stress the megakernels' group-of-lanes orderings (ties
    broken toward the lowest bank across ranks and channels, cores
    issuing to one bank in one tick, two channels parking reads of one
    core): `TIE_POLICIES` at 2 ranks x 2 channels in both modes, and
    40-bank cells (5 ranks x 8 banks: more banks than lanes, so a lane
    owns two) in both modes."""
    def spec(pol, scn, dens, seed, mode, **kw):
        return SweepSpec(policies=pol, scenarios=scn, densities=dens,
                         reqs=400, seed=seed, mode=mode, **kw)
    return [
        ("ties_closed", spec(TIE_POLICIES, (
            "closed_write_heavy", "closed_multirank",
            "closed_subarray_storm"), (8, 32), 5, "closed", n_ranks=2,
            n_channels=2)),
        ("ties_open", spec(TIE_POLICIES, (
            "bank_camping", "subarray_conflict_adversarial"), (8, 32), 5,
            "open", n_ranks=2, n_channels=2)),
        ("banks40_closed", spec(policies, ("closed_mixed",
                                           "closed_multirank"), (32,), 6,
                                "closed", n_ranks=5)),
        ("banks40_open", spec(policies, ("mixed", "bank_camping"), (32,), 6,
                              "open", n_ranks=5))]


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


FIXTURES = os.path.join(HERE, "tests", "fixtures", "megakernel")


def check_fixtures(sweep, SweepSpec):
    """The reference's golden megakernel cases (`tests/fixtures/
    megakernel/`: a sharded multirank x subarray shape, a one-cell grid,
    mixed-density open tiles) through A1 / A2, each equal to `batched`;
    closed cases with `record_commands`, which reconciles the kernel's
    cells with the emitting batched run."""
    out = []
    for name in sorted(os.listdir(FIXTURES)):
        with open(os.path.join(FIXTURES, name)) as f:
            case = json.load(f)
        spec = SweepSpec(policies=tuple(case["policies"]),
                         scenarios=tuple(case["scenarios"]),
                         densities=tuple(case["densities"]),
                         reqs=case["reqs"], seed=case["seed"],
                         mode=case["mode"], n_ranks=case.get("n_ranks", 1),
                         n_channels=case.get("n_channels", 1),
                         n_subarrays=case.get("n_subarrays", 1))
        closed = spec.mode == "closed"
        res = sweep(spec, "mega", record_commands=closed)
        require_equal(sweep(spec, "batched"), res,
                      f"fixture {name}: megakernel vs backend='batched'")
        if not all(c.finished for c in res.cells):
            raise AssertionError(f"fixture {name}: unfinished cells")
        out.append(dict(case=name, mode=spec.mode, cells=len(res.cells),
                        differing=0))
    if len(out) < 3:
        raise AssertionError(f"golden fixture corpus has {len(out)} cases")
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
    return runs, dict(
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
    """Kernel A1 and its plain version at the shape of `spec`'s grid (the
    phase-5 ladder rung, the paper grid), on the same device inputs; the
    two results must be equal."""
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
                launch=mega.launch_plan(cfg, n, params.device),
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
    """Kernel A2 and its plain version at the shape of `spec`'s grid (the
    open ladder rung, the open reference grid), on the same device
    inputs; the two results must be equal."""
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
                launch=mega.launch_plan(cfg, n, params.device),
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
TF32_TC_FLOPS = 495e12                   # dense tensor cores, TF32

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
# kv_quant: (p, t, h, d). Head dims 128, 112 and 64 (every model width of
# the repo, at the paged cache's 64-token page); rows of 24 bytes in bf16
# (8-byte vectors), of 24 / 12 bytes (8 / 4) and 20 / 10 bytes (4 / 2); a
# slice of 128 x 256 values, larger than the register tile, walked in 4
# tiles in f32 and 2 in bf16.
KV_QUANT_SHAPES = ((3, 8, 2, 16), (6, 64, 8, 128), (2, 5, 1, 12),
                   (2, 64, 2, 112), (2, 64, 2, 64), (2, 128, 1, 256),
                   (2, 3, 2, 6), (2, 4, 3, 5))
PAGED_CASES = (                           # b, h, hkv, d, t, maxp, lens
    (4, 10, 2, 16, 8, 4, (0, 9, 32, 1)),   # group 5, a zero length
    (2, 8, 8, 32, 16, 2, (17, 32)),        # group 1
    (3, 40, 8, 128, 64, 3, (130, 64, 1)),  # Qwen2.5-14B widths
    (2, 64, 4, 128, 64, 2, (100, 0)),      # Qwen3-MoE: group 16
    # six page splits with a ragged last page, and a sequence whose
    # splits past its first page have nothing to read
    (2, 40, 8, 128, 64, 96, (6100, 1)),
    # pages of 128 rows: two staged pieces a page, the last page's second
    # piece past seq_len
    (2, 16, 2, 64, 128, 4, (300, 129)))
# flash: (bh, sq, skv, d, q_scale). Sq != Skv both ways; blocks of 8 and
# 48 rows (not a multiple of 16); D of 4, 12 and 100 (not a multiple of 8
# or 16); q scaled by 8, which widens the scores 8x and moves the running
# max across tiles. (Scaling k and v too would widen the scores 64x, and
# the float32 plain version alone then lies further than FLASH_TOL from
# the exact result, so no float32 kernel that sums in another order could
# be held to it.)
FLASH_CASES = ((2, 64, 64, 16, 1), (1, 16, 16, 8, 1), (1, 256, 256, 64, 1),
               (2, 128, 128, 128, 1),
               (1, 128, 256, 128, 1), (2, 256, 128, 64, 1),
               (2, 8, 8, 16, 1), (1, 48, 48, 32, 1),
               (1, 64, 64, 4, 1), (2, 32, 32, 12, 1), (1, 128, 128, 100, 1),
               (1, 256, 256, 64, 8))
# ssd: (b, s, h, p, n, chunk). Chunks of 8 and 16 rows (one tensor-core
# tile, part of one); 64 chunks, whose state crosses 63 look-back steps;
# P and N not multiples of 16 (tiles padded with zeros).
SSD_CASES = ((2, 64, 3, 8, 16, 16), (2, 32, 1, 64, 8, 8),
             (1, 256, 2, 64, 128, 128), (2, 1024, 3, 64, 128, 16),
             (1, 64, 2, 12, 20, 32))


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


def flash_inputs(torch, g, bh, sq, skv, d, q_scale):
    """q [bh, sq, d] (times `q_scale`), k and v [bh, skv, d], float32 on
    the card, for a `FLASH_CASES` entry."""
    q = torch.randn((bh, sq, d), generator=g, device="cuda") * q_scale
    return (q, *(torch.randn((bh, skv, d), generator=g, device="cuda")
                 for _ in range(2)))


def check_kv_quant(torch, pages, q8, sc, what):
    """Kernel D's result `(q8, sc)` for `pages` against its plain version,
    exactly. The scales are equal bit for bit, and NaN where the plain
    version's are NaN (a NaN's payload is not compared). The int8 values
    are equal, and within the round trip `|x - q scale| <= 0.51 scale`,
    wherever `x / scale` is finite; where it is not (every value under a
    NaN scale, +-inf under an inf one) they are not compared, since the
    plain version's int8 of a NaN is undefined, and the kernel must store
    0 there (the clip does not turn a NaN into -127). Raises otherwise;
    returns the largest int8 difference where compared (0)."""
    from repro_torch.kernels import kv_quant as kq
    q8r, scr = kq.kv_quant_torch(pages)
    nan = torch.isnan(scr)
    if not (torch.equal(torch.isnan(sc), nan) and torch.equal(
            sc[~nan].view(torch.int32), scr[~nan].view(torch.int32))):
        raise AssertionError(f"{what}: scales differ from the plain "
                             f"version's")
    s = sc[:, None, :, None]
    x = pages.float()
    fin = torch.isfinite(x / s)
    diff = int((q8.int() - q8r.int())[fin].abs().max()) if bool(
        fin.any()) else 0
    if diff:
        raise AssertionError(f"{what}: int8 differs by {diff}")
    if bool(q8[~fin].any()):
        raise AssertionError(f"{what}: a value whose x / scale is not "
                             f"finite is stored as non-zero")
    if bool(((q8.float() * s - x).abs() > s * 0.51 + 1e-6)[fin].any()):
        raise AssertionError(f"{what}: the round trip exceeds 0.51 scale")
    return diff


def kv_quant_input(torch, g, shape, dtype, nonfinite=False):
    """Random pages of `shape` in `dtype`, with an all-zero head and
    values on the rounding boundaries; or, with `nonfinite`, with +inf and
    -inf in slice (0, 0) (an inf scale: its finite values quantize to 0)
    and a NaN in the last slice (a NaN scale). Needs two pages and d >= 4
    values a row."""
    x = torch.randn(shape, generator=g, device="cuda") * 3
    if nonfinite:
        x[0, 0, 0, 0], x[0, -1, 0, -1] = float("inf"), float("-inf")
        x[-1, -1, -1, 0] = float("nan")
    else:
        x[0, :, 0] = 0.0                                # an all-zero head
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
    groups 1, 5 and 16, and for flash `FLASH_CASES` (Sq != Skv, blocks
    of 8 and 48 rows, D of 4, 12 and 100, a wide score range), both input
    types."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_quant as kq
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import refresh_paged_attention as rpa
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    diff = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in KV_QUANT_SHAPES:
            for nonfinite in (False, True):
                x = kv_quant_input(torch, g, shape, dtype, nonfinite)
                diff = max(diff, check_kv_quant(
                    torch, x, *kq.kv_quant(x),
                    f"kv_quant {dtype} {shape} nonfinite={nonfinite}"))
    out["kv_quant"] = {"max_abs_err_int8": diff, "exact": diff == 0}
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
    for case in FLASH_CASES:
        q, k, v = flash_inputs(torch, g, *case)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
                got = fa.flash_attention(qd, kd, vd, causal=causal)
                want = fa.flash_attention_torch(qd, kd, vd, causal=causal)
                bh, sq, skv, d, qs = case
                key = (f"flash {dtype} BH{bh} Sq{sq} Skv{skv} D{d} "
                       f"q_scale{qs} causal={causal}")
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
    kq_diff = max(check_kv_quant(torch, *a, f"decode kv_quant {n}")
                  for n, a in (("K", (kp, k8, ks)), ("V", (vp, v8, vs))))
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
        kv_quant_max_abs_err_int8=kq_diff, kv_quant_exact=kq_diff == 0,
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
    # the pages read once, int8 pages and f32 scales written once: f32
    # as the path quantizes them, and bf16 as the reference's cache does
    # (its staging pages, src/repro/kvcache/paged.py)
    kpb = kp.to(torch.bfloat16)
    nbytes = 5 * kp.numel() + 4 * kp.shape[0] * kp.shape[2]
    ms, b_by = bound(nbytes, 0, 1.0)
    _, t_, _, d_ = kp.shape
    out["kv_quant"] = dict(
        shape=list(kp.shape), dtype="float32",
        ms=time_cuda(torch, lambda i: kq.kv_quant(kp), 20),
        plain_ms=time_cuda(torch, lambda i: kq.kv_quant_torch(kp), 5),
        bound_ms=ms, bound_by=b_by, bytes=nbytes,
        bf16_ms=time_cuda(torch, lambda i: kq.kv_quant(kpb), 20),
        bf16_plain_ms=time_cuda(torch, lambda i: kq.kv_quant_torch(kpb), 5),
        bf16_bound_ms=bound(nbytes - 2 * kp.numel(), 0, 1.0)[0],
        bf16_bytes=nbytes - 2 * kp.numel(),
        plan={"f32": kq.plan(t_, d_, 4), "bf16": kq.plan(t_, d_, 2),
              "order": "vector bytes, vectors a thread, threads a block"})
    del kpb
    # the int8 K and V of each sequence's first seq_len rows, the valid
    # pages' scales and table entries, and the lengths read once; q read
    # and the output written once
    rows = int(cache[-1].long().sum()) * QWEN_HKV * QWEN_D
    nbytes = (2 * rows + 2 * 4 * valid_pages * QWEN_HKV + 4 * valid_pages
              + 4 * DECODE_B + 2 * 4 * q.numel())
    ms, b_by = bound(nbytes, 0, 1.0)
    qb = q.to(torch.bfloat16)
    out["paged_attention"] = dict(
        q=list(q.shape), valid_pages=valid_pages, dtype="float32",
        ms=time_cuda(torch, lambda i: rpa.refresh_paged_attention(
            q, *cache, page_size=PAGE), 20),
        plain_ms=time_cuda(torch, lambda i: rpa.paged_attention_torch(
            q, *cache, page_size=PAGE), 5),
        serial_ms=time_cuda(torch, lambda i: ops.paged_attention_serial(
            q, *cache, page_size=PAGE), 5),
        # q in bfloat16: two bytes less a q and output value
        bf16_ms=time_cuda(torch, lambda i: rpa.refresh_paged_attention(
            qb, *cache, page_size=PAGE), 20),
        bf16_plain_ms=time_cuda(torch, lambda i: rpa.paged_attention_torch(
            qb, *cache, page_size=PAGE), 5),
        bound_ms=ms, bound_by=b_by, bytes=nbytes,
        bf16_bound_ms=bound(nbytes - 2 * 2 * q.numel(), 0, 1.0)[0])
    fl = fa.operations(QWEN_H, PREFILL_S, PREFILL_S, QWEN_D, True)
    for dt in (torch.bfloat16, torch.float32):
        a = [x.to(dt) for x in qkv]
        # q, k, v read once and the output written once
        nbytes = 4 * a[0].numel() * a[0].element_size()
        if dt == torch.bfloat16:
            ms, b_by = bound(nbytes, fl, BF16_TC_FLOPS)
            how = "bf16 tensor cores"
        else:
            # the least time for a float32-accurate result: the CUDA
            # cores' float32 rate, or three TF32 products (3xTF32) on the
            # tensor cores, whichever is faster
            (ms, b_by), how = min(
                (bound(nbytes, fl, FP32_FLOPS), "float32 CUDA cores"),
                (bound(nbytes, 3 * fl, TF32_TC_FLOPS),
                 "3xTF32 tensor cores"))
        out[f"flash_attention_{dtype_name(dt)}"] = dict(
            shape=list(a[0].shape), causal=True, operations=fl,
            bound_note=how,
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
    # as for E in float32: the CUDA cores' float32 rate or three TF32
    # products on the tensor cores, whichever is faster
    (ms, b_by), how = min(
        (bound(nbytes, fl, FP32_FLOPS), "float32 CUDA cores"),
        (bound(nbytes, 3 * fl, TF32_TC_FLOPS), "3xTF32 tensor cores"))
    out["mamba2_ssd"] = dict(
        x=[b, s, h, p], operations=fl, bound_note=how,
        ms=time_cuda(torch, lambda i: ssd.mamba2_ssd(*ssd_args,
                                                     chunk=SSD_CHUNK), 5),
        plain_ms=time_cuda(torch, lambda i: ssd.mamba2_ssd_torch(
            *ssd_args, chunk=SSD_CHUNK), 3),
        bound_ms=ms, bound_by=b_by, bytes=nbytes)
    return out


# ------------------------------------------------------------- phase 8
#: the reference's artifacts of `benchmarks/run.py --fast`, which the
#: port's scripts must reproduce field for field
ARTIFACTS = os.path.join(HERE, "results", "bench")
#: the paper grid at full load (reqs=2000, seeds 1 and 2): Figure 1's
#: losses and Figure 3's improvements over ref_ab at 32 Gb, in percent to
#: the digits given, as the reference computes them
FIG1_FULL_LOSS_PCT = {8: {"ref_ab": 4.263, "ref_pb": 3.433},
                      16: {"ref_ab": 6.349, "ref_pb": 4.249},
                      32: {"ref_ab": 9.662, "ref_pb": 9.075}}
FIG3_FULL_IMPR_32_PCT = {"dsarp": 8.83, "sarp_pb": 7.81, "hira": 7.81,
                         "darp": 4.34, "elastic": 3.62, "ref_pb": 0.65}


def require_same(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: {got!r} != {want!r}")


def load_artifact(name):
    with open(os.path.join(ARTIFACTS, f"{name}.json")) as f:
        return json.load(f)


def check_artifacts(got):
    """Every deterministic field of the port's `--fast` payloads (`got`:
    name -> payload as loaded JSON) equal to the reference's committed
    artifact of that name; timings are not compared."""
    for name in ("fig1_refresh_loss", "fig3_dsarp", "fig2_sarp_timeline",
                 "sarp_decode_bytes"):
        require_same(got[name], load_artifact(name), name)
    for name in ("sweep_grid", "sweep_closed_loop"):
        want = load_artifact(name)
        require_same(got[name]["grid"], want["grid"], f"{name} grid")
        require_same(got[name]["bit_identical"], True, f"{name} identity")
    for name, key in (("sweep_multirank", "per_rank_count"),
                      ("sweep_subarray", "per_subarray_count")):
        want = load_artifact(name)
        require_same(got[name]["grid"], want["grid"], f"{name} grid")
        require_same(got[name]["bit_identical"], True, f"{name} identity")
        require_same({k: v["weighted_speedup_vs_ideal"]
                      for k, v in got[name][key].items()},
                     {k: v["weighted_speedup_vs_ideal"]
                      for k, v in want[key].items()}, f"{name} tables")
    want = load_artifact("command_trace")
    for k in ("commands", "counts", "violations", "bit_identical",
              "disabled_emits_trace"):
        require_same(got["command_trace"][k], want[k], f"command_trace {k}")
    want, sm = load_artifact("sweep_mega"), got["sweep_mega"]
    require_same(sm["grid"], want["grid"], "sweep_mega grid")
    require_same([(r["rung"], r["cells"], r["bit_identical_cells_checked"])
                  for r in sm["ladder"]],
                 [(r["rung"], r["cells"], r["bit_identical_cells_checked"])
                  for r in want["ladder"]], "sweep_mega ladder")
    require_same(sm["bit_identical"], True, "sweep_mega identity")


def figures_phase(paper_runs):
    """The port's figure, bench and tool scripts (`benchmarks_torch/
    fig_refresh.py`, `bench_framework.py`, `tools/check_commands_torch.py`)
    at `benchmarks/run.py --fast`'s arguments, in this process, on the
    card: every deterministic field equal to the reference's committed
    artifact, timings reported. Then Figures 1 and 3 at full load from
    the paper grid's two sweeps (`paper_runs`, the same spec as
    `fig_grids(2000)`), held to the reference's values, ref_ab's loss
    above ref_pb's at 32 Gb and each loss growing with density. Writes
    nothing into the tree."""
    import contextlib
    import importlib.util
    import io
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from benchmarks_torch import bench_framework as BF
    from benchmarks_torch import fig_refresh as FR

    def as_json(obj):
        return json.loads(json.dumps(obj, default=str))

    secs, got = {}, {}

    def run(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        secs[name] = round(time.perf_counter() - t0, 3)
        return out

    runs = run("fig_grids", FR.fig_grids, reqs=800)
    if any(r.backend != "mega" for r in runs):
        raise AssertionError("fig_grids did not sweep on the megakernel")
    got["fig1_refresh_loss"] = as_json(FR.fig1(runs=runs))
    got["fig3_dsarp"] = as_json(FR.fig3(runs=runs))
    got["fig2_sarp_timeline"] = as_json(run("fig2", FR.fig2))
    got["sweep_grid"] = as_json(run("sweep_grid", FR.sweep_grid, fast=True))
    got["sweep_closed_loop"] = as_json(run("closed_loop", FR.closed_loop,
                                           fast=True))
    got["sweep_multirank"] = as_json(run("sweep_multirank",
                                         FR.sweep_multirank, fast=True))
    got["sweep_subarray"] = as_json(run("sweep_subarray", FR.sweep_subarray,
                                        fast=True))
    got["command_trace"] = as_json(run("command_trace", FR.command_trace,
                                       fast=True))
    got["sweep_mega"] = as_json(run("sweep_mega", FR.sweep_mega, fast=True))
    got["sarp_decode_bytes"] = as_json(BF.bench_sarp_bytes())
    spec = importlib.util.spec_from_file_location(
        "check_commands_torch",
        os.path.join(HERE, "tools", "check_commands_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tool.main([])
    secs["check_commands_torch"] = round(time.perf_counter() - t0, 3)
    tool_line = buf.getvalue().strip().splitlines()[-1]
    if rc != 0:
        raise AssertionError(f"check_commands_torch exited {rc}: "
                             f"{buf.getvalue()[-2000:]}")

    check_artifacts(got)
    sm = got["sweep_mega"]

    # full load: the paper grid's two sweeps
    f1 = FR.fig1(runs=paper_runs)
    f3 = FR.fig3(runs=paper_runs)
    loss = {d: {p: round(100 * v, 3) for p, v in row.items()}
            for d, row in f1.items()}
    impr = {p: round(100 * f3[32][p]["improvement_vs_refab"], 2)
            for p in FIG3_FULL_IMPR_32_PCT}
    require_same(loss, FIG1_FULL_LOSS_PCT, "Figure 1 at full load (%)")
    require_same(impr, FIG3_FULL_IMPR_32_PCT,
                 "Figure 3 at full load, improvement at 32 Gb (%)")
    if not f1[32]["ref_ab"] > f1[32]["ref_pb"]:
        raise AssertionError(f"Figure 1 at full load: ref_ab's loss is not "
                             f"above ref_pb's at 32 Gb: {f1[32]}")
    for p in ("ref_ab", "ref_pb"):
        if not f1[8][p] < f1[16][p] < f1[32][p]:
            raise AssertionError(f"Figure 1 at full load: {p}'s loss does "
                                 f"not grow with density: {loss}")
    return dict(
        phase="figures", artifacts_matched=sorted(got),
        check_commands=tool_line, seconds=secs,
        ladder=sm["ladder"], shards=sm["shards"],
        ref_grid_8x8x3=sm["ref_grid_8x8x3"],
        command_trace_overhead_pct=got["command_trace"]["overhead_pct"],
        fast_fig1_loss_32gb=got["fig1_refresh_loss"]["32"],
        full_load_fig1_loss_pct=loss,
        full_load_fig3_improvement_32gb_pct=impr,
        full_load_fig1=f1, full_load_fig3_32gb=f3[32])


def sass_counts(path):
    """Tensor-core instructions counted in `cuobjdump -sass` of the built
    library: HGMMA (`wgmma`) in kernel E's bf16 function, HMMA
    (`mma.sync`) in its f32 one and in kernel F. Raises if any is 0: the
    kernel would not be on the tensor cores."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    want = {"flash_attention_bf16_kernel": "HGMMA",
            "flash_attention_f32_kernel": "HMMA",
            "mamba2_ssd_kernel": "HMMA"}
    counts, fn = dict.fromkeys(want, 0), ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            continue
        for name, op in want.items():
            if name in fn and op in line:
                counts[name] += 1
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"no {want[name]} instruction in {name}: "
                                 f"it does not run on the tensor cores")
    return {"flash_bf16_HGMMA": counts["flash_attention_bf16_kernel"],
            "flash_f32_HMMA": counts["flash_attention_f32_kernel"],
            "ssd_HMMA": counts["mamba2_ssd_kernel"]}


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
    sass = sass_counts(_build.info["path"])
    emit({"phase": "build", "seconds": round(_build.info["seconds"], 3),
          "reused": _build.info["reused"], "library": os.path.relpath(
              _build.info["path"], HERE), "ptxas": regs, "sass": sass})

    # 3. kernels against their plain versions
    policies = tuple(list_policies())
    arb_err = check_arbiter(torch, np)
    grids = check_megakernel(sweep, conformance_specs(SweepSpec, policies))
    open_grids = check_megakernel(sweep,
                                  open_conformance_specs(SweepSpec, policies))
    lane_orders = check_megakernel(sweep, lane_order_specs(SweepSpec,
                                                           policies))
    wide = check_wide(torch, sweep, SweepSpec)
    fixtures = check_fixtures(sweep, SweepSpec)
    flt = check_float_kernels(torch, np)
    emit({"phase": "kernels", "arbiter": {
        "G": ARBITER_G, "B": ARBITER_B, "forms": ["closed", "open"],
        "max_abs_err": arb_err}, "megakernel": grids,
        "open_megakernel": open_grids, "lane_orders": lane_orders,
        "wide_128_banks": wide, "golden_fixtures": fixtures,
        "tolerance": 0, "float_kernels": flt, "float_tolerances": {
            "flash": FLASH_TOL, "paged_attention": PAGED_TOL,
            "mamba2_ssd": SSD_TOL, "kv_quant": "exact: scales bit for bit "
            "(NaN where NaN), int8 where x / s is finite (0 where not), "
            "|x - q s| <= 0.51 s"}})

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

    paper_runs, paper = drive(
        "paper_mega", "mega", paper_phase, sweep, SweepSpec, np)
    paper_spec, paper_res, _ = paper_runs[0]
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
    figs = drive("figures_mega", "mega+mega_open", figures_phase,
                 [res for _, res, _ in paper_runs])
    emit(dict(figs, launches=paths["figures_mega"]))
    by_path = {k: {p: n[k] for p, n in paths.items()} for k in counters}

    # timings at the main-path shapes (not counted as launches)
    ta = time_arbiter(torch, np, ARBITER_G)
    ta_paper = time_arbiter(torch, np, len(FIG3_POLICIES)
                            * len(CLOSED_FIG_SCENARIOS) * len(DENSITIES))
    tm = time_megakernel(torch, full_spec)
    tm_paper = time_megakernel(torch, paper_spec)
    to = time_open_megakernel(torch, ladder_spec_open)
    to_grid = time_open_megakernel(torch, open_spec)
    tf = time_float_kernels(torch, dec_in, qkv, ssd_args)
    emit({"phase": "timing", "arbiter": ta, "arbiter_paper_shape": ta_paper,
          "megakernel": tm, "megakernel_paper_grid": tm_paper,
          "open_megakernel": to, "open_megakernel_open_grid": to_grid, **tf,
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
         "library_ms": None, "launch": tm["launch"],
         "paper_grid": {k: tm_paper[k] for k in (
             "cells", "ms", "plain_ms", "bound_ms", "bound_by",
             "max_abs_err", "max_ticks_per_cell", "launch")}},
        {"name": "sweep_mega_open_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sweep_megakernel_open.cu",
         "replaces": "src/repro/kernels/sweep_megakernel.py:269",
         "launches": sum(by_path["mega_open"].values()),
         "launches_by_path": by_path["mega_open"],
         "timed_at": f"{to['cells']} cells (path open_ladder_mega)",
         "max_abs_err": to["max_abs_err"],
         "ms": to["ms"], "plain_ms": to["plain_ms"],
         "bound_ms": to["bound_ms"], "bound_by": to["bound_by"],
         "library_ms": None, "launch": to["launch"],
         "open_grid": {k: to_grid[k] for k in (
             "cells", "ms", "plain_ms", "bound_ms", "bound_by",
             "max_abs_err", "max_ticks_per_cell", "launch")}},
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
         "bf16_max_abs_err": dec["max_abs_err"]["torch.bfloat16"],
         "bf16_ms": tf["paged_attention"]["bf16_ms"],
         "bf16_plain_ms": tf["paged_attention"]["bf16_plain_ms"],
         "bf16_bound_ms": tf["paged_attention"]["bf16_bound_ms"],
         "split_pages": rpa.SPLIT_PAGES,
         "library_ms": None,
         "library_note": "no PyTorch call attends over an int8 paged cache; "
                         "serial_ms is ops.paged_attention_serial"},
        {"name": "kv_quant_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kv_quant.cu",
         "replaces": "src/repro/kernels/kv_quant.py:29",
         "launches": sum(by_path["kv_quant"].values()),
         "launches_by_path": by_path["kv_quant"],
         "timed_at": f"pages {tf['kv_quant']['shape']} float32 (path "
                     f"ops_paged_decode); bfloat16 in the bf16_* keys",
         "max_abs_err": dec["kv_quant_max_abs_err_int8"],
         "exact": dec["kv_quant_exact"],
         "ms": tf["kv_quant"]["ms"], "plain_ms": tf["kv_quant"]["plain_ms"],
         "bound_ms": tf["kv_quant"]["bound_ms"],
         "bound_by": tf["kv_quant"]["bound_by"],
         "bf16_ms": tf["kv_quant"]["bf16_ms"],
         "bf16_plain_ms": tf["kv_quant"]["bf16_plain_ms"],
         "bf16_bound_ms": tf["kv_quant"]["bf16_bound_ms"],
         "plan": tf["kv_quant"]["plan"], "library_ms": None,
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
         "bound_note": fl_bf["bound_note"],
         "f32_max_abs_err": pre["max_abs_err"]["torch.float32"],
         "f32_ms": fl_32["ms"], "f32_plain_ms": fl_32["plain_ms"],
         "f32_bound_ms": fl_32["bound_ms"],
         "f32_bound_by": fl_32["bound_by"],
         "f32_bound_note": fl_32["bound_note"],
         "f32_library_ms": fl_32["library_ms"],
         "sass_HGMMA_bf16": sass["flash_bf16_HGMMA"],
         "sass_HMMA_f32": sass["flash_f32_HMMA"]},
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
         "bound_by": tf["mamba2_ssd"]["bound_by"],
         "bound_note": tf["mamba2_ssd"]["bound_note"],
         "heads_per_block": ssd.HEADS_PER_BLOCK,
         "sass_HMMA": sass["ssd_HMMA"], "library_ms": None,
         "library_note": "PyTorch has no SSD scan"}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
