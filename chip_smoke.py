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
              rows at G=100128, B=8, closed (`occ`) and open form; the
              tick-loop megakernel against `backend="torch"` on the card
              and `backend="batched"` on the host over the conformance,
              multirank and subarray grids;
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
              `ladder_torch_arbiter`).

The megakernel scores inside its own tick loop and never calls the
arbiter kernel: the arbiter kernel is on the `arbiter="cuda"` paths only.
Both kernels' launch counters are set to 0 just before each of the four
paths and read just after it, and reported per path; a path that did not
launch its kernel fails the run. Afterwards each kernel is timed at the
shape its full-width path gives it (CUDA events) beside its plain version
and its bound, and held against the plain version once more at that
shape; the arbiter kernel is also timed at the paper path's [120, 8].
Those launches are not counted. The line before the last is
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


def check_megakernel(sweep, SweepSpec, policies):
    """Kernel vs the torch tick body on the card (plain arbiter, then
    the arbiter kernel inside the torch body) and vs numpy `batched` on
    the host; exact on every `CellResult` field."""
    out = []
    for name, spec in conformance_specs(SweepSpec, policies):
        t0 = time.perf_counter()
        mega = sweep(spec, "mega")
        plain = sweep(spec, "torch")
        require_equal(plain, mega, f"{name}: megakernel vs backend='torch'")
        require_equal(sweep(spec, "batched"), mega,
                      f"{name}: megakernel vs backend='batched'")
        if name == "conformance":
            require_equal(sweep(spec, "torch", arbiter="cuda"), plain,
                          f"{name}: torch body with the arbiter kernel")
        if not all(c.finished for c in mega.cells):
            raise AssertionError(f"{name}: unfinished cells")
        out.append(dict(grid=name, cells=len(mega.cells), differing=0,
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
    from repro_torch.core.refresh.scenarios import make_closed_demand
    from repro_torch.core.sweep import SweepSpec, sweep
    from repro_torch.kernels import _build
    from repro_torch.kernels import sweep_arbiter as arb
    from repro_torch.kernels import sweep_megakernel as mega
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
            if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(_build.info["seconds"], 3),
          "reused": _build.info["reused"], "library": os.path.relpath(
              _build.info["path"], HERE), "ptxas": regs})

    # 3. kernels against their plain versions
    policies = tuple(list_policies())
    arb_err = check_arbiter(torch, np)
    grids = check_megakernel(sweep, SweepSpec, policies)
    emit({"phase": "kernels", "arbiter": {
        "G": ARBITER_G, "B": ARBITER_B, "forms": ["closed", "open"],
        "max_abs_err": arb_err}, "megakernel": grids,
        "tolerance": 0})

    # 4 + 5. the main paths, each with both launch counters from zero
    paths = {}

    def drive(label, expects, fn, *args):
        arb.LAUNCHES = mega.LAUNCHES = 0
        out = fn(*args)
        paths[label] = {"mega": mega.LAUNCHES, "arbiter": arb.LAUNCHES}
        if paths[label][expects] <= 0:
            raise AssertionError(f"path {label} never launched the "
                                 f"{expects} kernel")
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
    by_path = {k: {p: n[k] for p, n in paths.items()}
               for k in ("mega", "arbiter")}

    # timings at the main-path shapes (not counted as launches)
    ta = time_arbiter(torch, np, ARBITER_G)
    ta_paper = time_arbiter(torch, np, len(FIG3_POLICIES)
                            * len(CLOSED_FIG_SCENARIOS) * len(DENSITIES))
    tm = time_megakernel(torch, full_spec)
    emit({"phase": "timing", "arbiter": ta, "arbiter_paper_shape": ta_paper,
          "megakernel": tm,
          "seconds_total": round(time.perf_counter() - t_start, 1)})
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
         "library_ms": None}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
