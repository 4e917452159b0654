#!/usr/bin/env python3
"""Device check of the PyTorch/CUDA port: `python3 chip_smoke.py`.

Needs one NVIDIA GPU (written for an H100), PyTorch built for CUDA and
`nvcc`; takes no arguments; needs no network. It drives the port
(`src/repro_torch`) only — nothing of JAX, nothing of the JAX package —
and prints one JSON object a line:

  0. contract the port's static checks (`repro_torch.analysis`, as
              `tools/check_contract_torch.py` runs them: the reference's
              passes on the port's files and `cuda-lint`), before anything
              is built: findings, suppressed, seconds; a finding fails;
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
  9. serving  the port's serving path at the full width of qwen2-0.5b
              (24 layers, d_model 896, 14 q / 2 kv heads of 64, vocab
              151936), f32 params and compute, random weights from seed 0
              on the card: `repro_torch.models.transformer` `prefill` of
              2 x 512 and 2 x 300 tokens (kernel E the causal attention,
              24 launches a forward, the 300-token one padded to 384
              rows) and 8 `decode_step`s, hidden states and K/V held
              against the same calls with the plain attention in E's
              place and the decode logits against the forward's, at
              `MODEL_REL` of the largest magnitude (path
              `model_prefill_flash`); then `repro_torch.launch.serve`'s
              defaults through `EngineCore.run_until_done` (6 mixed
              requests, 16 new tokens, darp, pages of 4, bf16 staging),
              kernel D the page compressions, one decode round's logits
              held against the same call on the CPU with the same cache
              state, and the greedy streams against a CPU run of the same
              engine (path `serve_engine`).
 10. families the port's other model families at full width, f32, random
              weights from a seeded generator on the card: mamba2-130m
              (`prefill` of 2 x 512 tokens, and of 2 x 384 then 128
              `decode_step`s; kernel F every layer's SSD, 24 launches a
              prefill, its final state the decode state), held against
              the same calls with the plain SSD in F's place (hidden
              states, every layer's SSD and conv states), the decode
              logits against the forward's, the last logits against a
              CPU run (path `model_ssm_ssd`); zamba2-7b (`prefill` of
              1 x 512 and 4 `decode_step`s: F in its 68 Mamba layers, E
              causal with head dim 112 in the 13 applications of the
              shared attention), held against the same calls with the
              plain SSD and attention (path `model_hybrid`);
              seamless-m4t-large-v2 (frame embeddings [2, 300, 1024] from
              a seed, the BOS `prefill` and 8 `decode_step`s: E in all 72
              attentions, the encoder's 300 x 300 and the cross 1 x 300
              non-causal with ragged keys), held against the plain
              attention (path `model_encdec_flash`); all at `MODEL_REL`.
 11. training the port's train step on the card at full width, f32 (path
              `model_train_step`): one `make_train_step` step of
              qwen2-0.5b at batch 2 x 512 with `accum` 1 and 2, and of
              mamba2-130m at 2 x 512, from `SyntheticLMData(seed=0)`;
              kernel E is the forward of every attention and F of every
              Mamba layer's SSD, each launched again in the layer's
              rematerialized forward (E 48 / 96, F 48 launches a step),
              both inside `torch.autograd.Function`s whose backward is
              autograd of the plain version. The loss and every gradient
              leaf are held against the same call with no kernel
              (`plain_train`) at `MODEL_REL`, the q/k/v and Mamba input
              projections' gradients non-zero; ms a step, tokens/s and
              the device's busy share. Then the trainer (path
              `trainer_ckpt`): `bench_darp_ckpt` at `run.py --fast`'s 20
              steps on the reduced qwen2.5-3b, its `flushes` equal to the
              reference's `results/bench/darp_ckpt.json`; a bit-exact
              checkpoint round trip of a CUDA train state with bf16
              moments; `python -m repro_torch.launch.train --reduced
              --steps 12 --device cuda --ckpt-dir ...` exiting 0.
              Between the two, the sharded step (path
              `sharded_train_step`): the qwen2-0.5b accum-1 case through
              the multi-card API on a world of one card (an NCCL group,
              `make_host_mesh`, `to_shardings`, DTensor state and batch,
              `sharding_context` with every `shd` active, E through
              `local_map`), its loss, gradients, m and params held
              against the unsharded run, E 48 launches a step as
              unsharded; the group is destroyed before the next path.
 12. dry run  the one-card dry run held on the card (path `dryrun`), for
              qwen2-0.5b and mamba2-130m at `model_train_step`'s 2 x 512,
              f32: `launch.specs.state_shapes_and_specs`' `meta` leaves
              equal `make_state`'s on the card, shape and dtype, leaf for
              leaf; `parallel.op_analysis.analyze_ops` of the train step
              on `meta` counts exactly the FLOPs and product FLOPs of the
              same step on the card with the plain route patched in
              (`plain_route`), and the step through kernels E and F counts
              fewer (a ctypes launch is invisible to a dispatch mode); the
              step's ms on each route beside the dry run's bound. Then
              the dry run on the production meshes with this machine's
              torch (path `dryrun_pods`, no kernel, nothing on the card):
              qwen2-0.5b's decode_32k and train_4k on one card, on
              (data=16, model=16) and on (pod=2, data=16, model=16), each
              production mesh in a fake world of 256 or 512 ranks on
              `meta`; every record `ok`, train_4k with all-gathers and
              all-reduces, a device's arguments between the one-card
              record's over the devices and the one-card record's; one
              line a cell with its host seconds. After the timings,
              `python -m repro_torch.launch.dryrun --one-card-only` over
              every shape of one arch a family (`DRYRUN_FAMILY_ARCHS`,
              one process an arch, all started together), one line a
              cell, every cell `ok`.

The megakernels score inside their own tick loops and never call the
arbiter kernel: the arbiter kernel is on the `arbiter="cuda"` paths only.
The seven kernels' launch counters are set to 0 just before each of the
twenty-two paths and read just after it, and reported per path; a path that
did not launch its kernels fails the run (`dryrun_pods` has none).
Afterwards each kernel is timed at the shape its full-width path gives
it (CUDA events) beside its plain version and its bound (E's f32 bound
and F's are the lesser of the CUDA cores' float32 rate and three TF32
products at the TF32 tensor-core rate, since both run 3xTF32; E beside
`scaled_dot_product_attention`, C
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

if os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
    sys.path.insert(0, os.path.join(HERE, "src"))
    # published H100 SXM peaks used for the bounds (NVIDIA data sheet),
    # defined once in the dry run's `op_analysis`: device memory rate, the
    # float32 rate outside the tensor cores, the bf16 and TF32 tensor-core
    # rates. The sweep kernels do int32 arithmetic: the SM issues int32 on
    # half of its float32 lanes and the float32 figure counts a fused
    # multiply-add as 2.
    from repro_torch.parallel.op_analysis import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.parallel.op_analysis import PEAK_FLOPS
    FP32_FLOPS = PEAK_FLOPS["float32"]
    INT32_OPS = FP32_FLOPS / 4
    BF16_TC_FLOPS = PEAK_FLOPS["bfloat16"]  # dense tensor cores, bf16
    TF32_TC_FLOPS = PEAK_FLOPS["tf32"]      # dense tensor cores, TF32

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
# tiles in f32 and 2 in bf16; and the serving engine's staging slice at
# qwen2-0.5b (24 layers in the page axis, pages of 4 tokens, 2 kv heads
# of 64), which `PagedKVCache.compress_page` hands to D (path
# `serve_engine`).
KV_QUANT_SHAPES = ((3, 8, 2, 16), (6, 64, 8, 128), (2, 5, 1, 12),
                   (2, 64, 2, 112), (2, 64, 2, 64), (2, 128, 1, 256),
                   (2, 3, 2, 6), (2, 4, 3, 5), (24, 4, 2, 64))
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
# The last four are the models' lengths, which E's blocks do not divide
# and which go through `flash_attention_ragged` (`flash_entry`): the
# encoder-decoder's cross-attention at its BOS prefill (1 query over 300
# frames) and its encoder (300 x 300), a longer ragged pair (1000: 8
# padded q blocks, 16 kv tiles of 64 with a ragged last one), and
# zamba2's head dim 112 (divided, through `flash_attention`).
FLASH_CASES = ((2, 64, 64, 16, 1), (1, 16, 16, 8, 1), (1, 256, 256, 64, 1),
               (2, 128, 128, 128, 1),
               (1, 128, 256, 128, 1), (2, 256, 128, 64, 1),
               (2, 8, 8, 16, 1), (1, 48, 48, 32, 1),
               (1, 64, 64, 4, 1), (2, 32, 32, 12, 1), (1, 128, 128, 100, 1),
               (1, 256, 256, 64, 8),
               (2, 1, 300, 64, 1), (2, 300, 300, 64, 1),
               (1, 1000, 1000, 64, 1), (2, 256, 256, 112, 1))
# ssd: (b, s, h, p, n, chunk). Chunks of 8 and 16 rows (one tensor-core
# tile, part of one); 64 chunks, whose state crosses 63 look-back steps;
# P and N not multiples of 16 (tiles padded with zeros).
SSD_CASES = ((2, 64, 3, 8, 16, 16), (2, 32, 1, 64, 8, 8),
             (1, 256, 2, 64, 128, 128), (2, 1024, 3, 64, 128, 16),
             (1, 64, 2, 12, 20, 32))


def flash_entry(fa, sq, skv):
    """Kernel E's entry point for lengths (sq, skv): `flash_attention`
    where E's 128-row blocks divide them (the TPU kernel's contract),
    else `flash_attention_ragged`, the models' route."""
    try:
        fa.blocks(sq, skv)
    except ValueError:
        return fa.flash_attention_ragged
    return fa.flash_attention


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
    of 8 and 48 rows, D of 4, 12, 100 and 112, a wide score range, the
    models' ragged lengths through `flash_attention_ragged`), both input
    types; F's y with and without its final state, and the state."""
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
                bh, sq, skv, d, qs = case
                got = flash_entry(fa, sq, skv)(qd, kd, vd, causal=causal)
                want = fa.flash_attention_torch(qd, kd, vd, causal=causal)
                key = (f"flash {dtype} BH{bh} Sq{sq} Skv{skv} D{d} "
                       f"q_scale{qs} causal={causal}")
                errs[key] = close(torch, got, want,
                                  *FLASH_TOL[dtype_name(dtype)], key)
    out["flash_attention"] = errs
    errs = {}
    for (b, s, h, p, n, chunk) in SSD_CASES:
        args = ssd_inputs(torch, g, b, s, h, p, n)
        key = f"ssd B{b} S{s} H{h} P{p} N{n} chunk{chunk}"
        y_want, st_want = ssd.mamba2_ssd_with_state_torch(*args, chunk=chunk)
        errs[key] = close(torch, ssd.mamba2_ssd(*args, chunk=chunk), y_want,
                          *SSD_TOL, key)
        y, st = ssd.mamba2_ssd_with_state(*args, chunk=chunk)
        errs[key + " with state: y"] = close(torch, y, y_want, *SSD_TOL,
                                             key + " with state: y")
        errs[key + " final state"] = close(torch, st, st_want, *SSD_TOL,
                                           key + " final state")
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


#: the fields of the serving benches that the engine's scheduling decides
#: (rounds, pages, policies: never the weights or the clock), per entry
SERVING_POLICY_FIELDS = ("tokens", "forced_stalls", "compressions")
SERVING_LIFECYCLE_FIELDS = ("tokens", "timed_out", "evictions", "completed",
                            "evicted", "stall_rounds", "dram_stall_ticks",
                            "prefill_calls", "decode_calls",
                            "maintenance_events")


def check_serving_artifacts(got):
    """The port's `--fast` serving payloads (`serving_policies`,
    `serving_lifecycle`, `serving_cosim`) against the reference's
    committed artifacts: every scheduling field of every policy (tokens,
    stalls, compressions, evictions, prompt lengths, the prefill/decode
    call split), the co-sim's per-policy summaries whole (tick-space, so
    deterministic) and its orderings over the policies run, and the
    bit-identical pin. Wall-clock fields are not compared."""
    want = load_artifact("serving_policies")
    require_same(sorted(got["serving_policies"]), sorted(want),
                 "serving_policies policies")
    for pol, w in want.items():
        for k in SERVING_POLICY_FIELDS:
            require_same(got["serving_policies"][pol][k], w[k],
                         f"serving_policies {pol} {k}")
    want, sl = load_artifact("serving_lifecycle"), got["serving_lifecycle"]
    for k in ("prompt_lens", "max_new", "prefill_chunk"):
        require_same(sl[k], want[k], f"serving_lifecycle {k}")
    for pol in ("darp", "all_bank"):
        for k in SERVING_LIFECYCLE_FIELDS:
            require_same(sl[pol][k], want[pol][k],
                         f"serving_lifecycle {pol} {k}")
    want, sc = load_artifact("serving_cosim"), got["serving_cosim"]
    for k in ("scenario", "n_requests", "seed"):
        require_same(sc[k], want[k], f"serving_cosim {k}")
    pols = sc["policies"]
    for pol in pols:
        require_same(sc[pol], want[pol], f"serving_cosim {pol}")
    for flag, key in (("ttft_p99_ordered", lambda x: x["ttft_ticks"]["p99"]),
                      ("tpot_p99_ordered", lambda x: x["tpot_ticks"]["p99"]),
                      ("stall_ordered", lambda x: x["dram_stall_ticks"])):
        vals = [key(want[p]) for p in pols]
        require_same(sc[flag], all(a <= b for a, b in zip(vals, vals[1:])),
                     f"serving_cosim {flag}")
    require_same(sc["bit_identical"], True, "serving_cosim identity")


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


# ------------------------------------------------------------- phase 9
# the serving path of the port at the full width of the reference's own
# serving default, qwen2-0.5b (src/repro/launch/serve.py:39;
# src/repro/configs/qwen2_0_5b.py: 24 layers, d_model 896, d_ff 4864, 14
# q heads and 2 kv heads of 64, vocab 151936, tied embeddings, QKV bias),
# f32 params and compute, random weights from seed 0 on the card.
MODEL_ARCH = "qwen2-0.5b"
MODEL_B, MODEL_S, MODEL_RAGGED, MODEL_DECODE = 2, 512, 300, 8
#: the model paths' bar: kernel against plain version (prefill hidden
#: states, caches) and card against CPU (serving logits), each within
#: this share of the plain / CPU result's largest magnitude. Both sides
#: compute in float32 (TF32 off); they differ by summation order through
#: 24 layers, ~1e-6 of the magnitude.
MODEL_REL = 1e-4


def held(torch, got, want, what, rel=MODEL_REL):
    """Max abs difference of two float tensors of one shape, raised on
    beyond `rel` of `want`'s largest magnitude (or a non-finite value)."""
    g, w = got.float(), want.float().to(got.device)
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shapes {tuple(g.shape)} and "
                             f"{tuple(w.shape)}")
    err = float((g - w).abs().max())
    bar = rel * float(w.abs().max())
    if not (bool(torch.isfinite(g).all()) and err <= bar):
        raise AssertionError(f"{what}: max abs difference {err} over the "
                             f"bar {bar}")
    return err


def plain_attention(fa):
    """A context in which kernel E's wrappers (`flash_attention` and the
    models' route `flash_attention_ragged`) compute with their plain
    version (`ref.flash_attention`) on the card: the model's layers then
    run their same code with the plain attention in E's place."""
    import contextlib
    from unittest import mock

    def plain(q, k, v, *, causal=True):
        return fa.flash_attention_torch(q, k, v, causal=causal)
    stack = contextlib.ExitStack()
    for name in ("flash_attention", "flash_attention_ragged"):
        stack.enter_context(mock.patch.object(fa, name, plain))
    return stack


def plain_ssd(ssd):
    """A context in which kernel F's model route
    (`mamba2_ssd_with_state`) computes with its plain version
    (`ref.mamba2_ssd_with_state`) on the card: the Mamba layers then run
    their same code with the plain SSD in F's place."""
    from unittest import mock
    return mock.patch.object(ssd, "mamba2_ssd_with_state",
                             ssd.mamba2_ssd_with_state_torch)


def model_prefill_path(torch, np):
    """qwen2-0.5b at full width through `repro_torch.models.transformer`:
    `prefill` of 2 x 512 tokens and of 2 x 300 (padded to 384 rows for
    kernel E), then 8 `decode_step`s after the 512-token prefill. E is
    the causal attention of every layer: 24 launches a forward. Returns
    what the checks need and the path's numbers."""
    from repro_torch.common.config import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.models.dims import make_dims
    cfg = get_arch(MODEL_ARCH)
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init(gen, cfg, dims, "cuda")
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (MODEL_B, MODEL_S + MODEL_DECODE))).cuda()
    out = {}
    for s in (MODEL_S, MODEL_RAGGED):
        before = fa.LAUNCHES
        fwd = T.forward(params, cfg, dims, tokens=toks[:, :s], mode="prefill")
        out[s] = dict(fwd=fwd, launches=fa.LAUNCHES - before)
        batch = {"tokens": toks[:, :s]}
        out[s]["prefill_ms"] = time_cuda(
            torch, lambda i: T.prefill(params, batch, cfg, dims), 3)
    logits, caches = T.prefill(params, {"tokens": toks[:, :MODEL_S]}, cfg,
                               dims)
    state = T.init_decode_state(cfg, dims, MODEL_B, MODEL_S + MODEL_DECODE,
                                "cuda")
    for k in state:
        state[k][:, :, :MODEL_S] = caches[k]
    step_logits, step_ms = [], []
    for t in range(MODEL_DECODE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, state = T.decode_step(params, state, cfg, dims,
                                  token=toks[:, MODEL_S + t],
                                  pos=MODEL_S + t)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        step_logits.append(lg)
    profiles = {
        "prefill_512": device_share(torch, lambda: T.prefill(
            params, {"tokens": toks[:, :MODEL_S]}, cfg, dims)),
        "decode_step": device_share(torch, lambda: T.decode_step(
            params, state, cfg, dims, token=toks[:, -1],
            pos=MODEL_S + MODEL_DECODE - 1))}
    return dict(cfg=cfg, dims=dims, params=params, toks=toks, out=out,
                step_logits=torch.stack(step_logits, 1)), dict(
        phase="model_prefill_flash", model=MODEL_ARCH, dtype="float32",
        layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
        heads=[cfg.attention.n_heads, cfg.attention.n_kv_heads,
               cfg.attention.head_dim], vocab=cfg.vocab_size,
        prefill_shapes=[[MODEL_B, s] for s in (MODEL_S, MODEL_RAGGED)],
        flash_launches_a_forward={str(s): out[s]["launches"]
                                  for s in out},
        prefill_ms={str(s): out[s]["prefill_ms"] for s in out},
        decode_steps=MODEL_DECODE,
        decode_ms_a_step=sum(step_ms[1:]) / (len(step_ms) - 1),
        decode_ms_first_step=step_ms[0], profiles=profiles)


def check_model_prefill(torch, run):
    """The model path held: each prefill's hidden states and K/V caches
    against the same forward with the plain attention in E's place, and
    the 8 decode logits against the forward's logits at those positions
    (decode is plain torch; the forward over 520 tokens is E, padded to
    640 rows). Every forward must have launched E once a layer."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.models.loss import logits_for
    cfg, dims, params = run["cfg"], run["dims"], run["params"]
    errs = {}
    for s, o in run["out"].items():
        if o["launches"] != cfg.n_layers:
            raise AssertionError(f"prefill {s}: {o['launches']} flash "
                                 f"launches, not one a layer")
        with plain_attention(fa):
            h, _, caches = T.forward(params, cfg, dims,
                                     tokens=run["toks"][:, :s],
                                     mode="prefill")
        hk, _, ck = o["fwd"]
        errs[f"hidden_{s}"] = held(torch, hk, h, f"prefill {s} hidden")
        errs[f"k_{s}"] = held(torch, ck["k"], caches["k"], f"prefill {s} k")
        errs[f"v_{s}"] = held(torch, ck["v"], caches["v"], f"prefill {s} v")
    n = MODEL_S + MODEL_DECODE
    h, _, _ = T.forward(params, cfg, dims, tokens=run["toks"][:, :n])
    want = logits_for(h[:, MODEL_S:].reshape(-1, cfg.d_model),
                           T._head_matrix(params, dims), cfg.vocab_size)
    v = cfg.vocab_size
    got = run["step_logits"].reshape(-1, dims.vocab)
    errs["decode_logits"] = held(torch, got[:, :v], want[:, :v],
                                 "decode logits vs forward")
    return errs


def time_model_kernels(torch):
    """E and D at the shapes the serving paths give them, beside their
    plain versions and bounds (CUDA events; these launches are not
    counted): E causal in float32 on q/k/v [28, 512, 64], qwen2-0.5b's 14
    q heads x batch 2 of the 512-token prefill, and on [28, 384, 64], the
    300-token prefill padded; E beside `scaled_dot_product_attention`.
    D on the engine's bf16 staging slice [24, 4, 2, 64]. Each time is
    held against its plain version first."""
    import torch.nn.functional as F
    from repro_torch.common.config import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_quant as kq
    att = get_arch(MODEL_ARCH).attention
    g = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    bh, d = MODEL_B * att.n_heads, att.head_dim
    for s in (MODEL_S, -MODEL_RAGGED // fa.BLOCK * -fa.BLOCK):
        a = [torch.randn((bh, s, d), generator=g, device="cuda")
             for _ in range(3)]
        err = close(torch, fa.flash_attention(*a, causal=True),
                    fa.flash_attention_torch(*a, causal=True),
                    *FLASH_TOL["float32"], f"flash at the model shape {s}")
        fl = fa.operations(bh, s, s, d, True)
        (ms, b_by), how = min(
            (bound(4 * a[0].numel() * 4, fl, FP32_FLOPS),
             "float32 CUDA cores"),
            (bound(4 * a[0].numel() * 4, 3 * fl, TF32_TC_FLOPS),
             "3xTF32 tensor cores"))
        out[f"flash_attention_{s}"] = dict(
            shape=[bh, s, d], dtype="float32", causal=True,
            max_abs_err=err,
            ms=time_cuda(torch, lambda i: fa.flash_attention(
                *a, causal=True), 50, stall_ms=5),
            plain_ms=time_cuda(torch, lambda i: fa.flash_attention_torch(
                *a, causal=True), 20, stall_ms=5),
            library_ms=time_cuda(torch, lambda i:
                                 F.scaled_dot_product_attention(
                                     *[x[None] for x in a], is_causal=True),
                                 50, stall_ms=5),
            bound_ms=ms, bound_by=b_by, bound_note=how)
    shape = KV_QUANT_SHAPES[-1]                  # the engine's page
    pages = kv_quant_input(torch, g, shape, torch.bfloat16)
    err = check_kv_quant(torch, pages, *kq.kv_quant(pages),
                         "kv_quant at the engine's page")
    nbytes = 3 * pages.numel() + 4 * shape[0] * shape[2]
    ms, b_by = bound(nbytes, 0, 1.0)
    out["kv_quant"] = dict(
        shape=list(pages.shape), dtype="bfloat16", max_abs_err=err,
        ms=time_cuda(torch, lambda i: kq.kv_quant(pages), 200, stall_ms=5),
        plain_ms=time_cuda(torch, lambda i: kq.kv_quant_torch(pages), 50,
                           stall_ms=5),
        bound_ms=ms, bound_by=b_by, bytes=nbytes)
    return out


def device_share(torch, fn):
    """One warm call of `fn` under `torch.profiler`: its wall ms
    (synchronized), the device's busy ms in it (the summed durations of
    the device events the profiler records: kernels, copies, fills, which
    one stream runs one after another) and their count. `device_ms` and
    `busy_share` are None where the profiler records no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return dict(wall_ms=wall, device_events=len(dev),
                device_ms=busy if dev else None,
                busy_share=busy / wall if dev else None)


def cache_copy(torch, cache, device):
    """A copy of a `PagedKVCache` (tensors and bookkeeping) on `device`."""
    import copy
    c = copy.copy(cache)
    c.device = torch.device(device)
    for name in ("k_pages", "v_pages", "k_scale", "v_scale", "k_staging",
                 "v_staging"):
        setattr(c, name, getattr(cache, name).to(device, copy=True))
    for name in ("page_table", "seq_len", "active", "page_state",
                 "staging_slot"):
        setattr(c, name, getattr(cache, name).copy())
    c.free_pages, c.free_staging = list(cache.free_pages), list(
        cache.free_staging)
    c.stats = dict(cache.stats)
    return c


def serve_engine_path(torch, np):
    """`repro_torch.launch.serve`'s defaults at full width on the card:
    qwen2-0.5b, f32, 6 `--mixed` requests of 16 new tokens, policy darp,
    pages of 4 tokens, bf16 staging (256 pages, 24 staging pages, 4
    groups, 8 sequences, batch 4, prefill chunk 8), drained by
    `EngineCore.run_until_done`. Page compressions are kernel D. The
    first decode round that reads compressed pages of two or more
    sequences is snapshotted (the cache copied to the host) for the CPU
    check."""
    from repro_torch.launch import serve
    from repro_torch.serving import paged_decode as pd
    args = serve.parse_args(["--mixed", "--device", "cuda"])
    cfg, dims = serve.config_for(args)
    params = serve.init_params(args, cfg, dims)
    snap = {}

    def decode_fn(params, cfg, dims, cache, sids, tokens):
        out = pd.paged_decode_forward(params, cfg, dims, cache, sids, tokens)
        if not snap and cache.stats["compressions"] and len(sids) > 1:
            snap.update(cache=cache_copy(torch, cache, "cpu"),
                        sids=list(sids), tokens=tokens.cpu(),
                        logits=out[0].cpu())
        return out

    eng, handles = serve.build_engine(args, params, decode_fn=decode_fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_done(max_rounds=args.max_rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.stats["timed_out"]:
        raise AssertionError("serve_engine: the engine timed out before "
                             "draining")
    if not snap:
        raise AssertionError("serve_engine: no decode round read "
                             "compressed pages")
    summ = eng.metrics_summary()
    cs = eng.cache.stats
    again = cache_copy(torch, snap["cache"], "cuda")
    profile = device_share(torch, lambda: pd.paged_decode_forward(
        params, cfg, dims, again, snap["sids"], snap["tokens"].cuda()))
    return dict(args=args, params=params, handles=handles, snap=snap,
                compressions=cs["compressions"]), dict(
        phase="serve_engine", model=MODEL_ARCH, dtype="float32",
        staging="bfloat16", policy=args.policy, requests=args.requests,
        new=args.new, prompt_lens=[len(h.prompt) for h in handles],
        states=sorted({h.state.value for h in handles}),
        tokens=eng.stats["tokens"], seconds=round(wall, 3),
        tok_per_s=eng.stats["tokens"] / wall,
        ttft_ms={k: summ["ttft"][k] for k in ("p50_ms", "p99_ms")},
        tpot_ms={k: summ["tpot"][k] for k in ("p50_ms", "p99_ms")},
        compressions=cs["compressions"], forced=cs["forced"],
        evictions=eng.stats["evictions"],
        stall_rounds=eng.stats["stall_rounds"], rounds=eng.stats["rounds"],
        prefill_calls=eng.stats["prefill_calls"],
        decode_calls=eng.stats["decode_calls"],
        decode_round_profile=dict(profile, sequences=len(snap["sids"])))


def check_serve_on_cpu(torch, run, kv_launches):
    """The serving path held against the CPU: the snapshotted decode
    round's logits from `paged_decode_forward` on the card against the
    same call on the CPU, same cache state, params moved there; then the
    same engine run on the CPU, its greedy streams against the card's. A
    token may differ only where the CPU's top-2 logit margin at that step
    is within twice the bar (each of the two logits may move by the bar);
    tokens after a request's first difference follow another input and
    are counted, not held. Kernel D launched twice a compression (K and
    V)."""
    from repro_torch.launch import serve
    from repro_torch.serving import paged_decode as pd
    from repro_torch.common.treeutil import tree_map
    if kv_launches != 2 * run["compressions"]:
        raise AssertionError(f"serve_engine: {kv_launches} kv_quant "
                             f"launches for {run['compressions']} "
                             f"compressions")
    args, snap = run["args"], run["snap"]
    params = tree_map(lambda x: x.cpu(), run["params"])
    cfg, dims = serve.config_for(args)
    lg, _, _ = pd.paged_decode_forward(params, cfg, dims, snap["cache"],
                                       snap["sids"], snap["tokens"])
    v = cfg.vocab_size
    logits_err = held(torch, snap["logits"][:, :v], lg[:, :v],
                      "serving logits, card vs CPU")
    cpu_args = serve.parse_args(["--mixed", "--device", "cpu"])
    last, margins = {}, {}

    def decode_fn(params, cfg, dims, cache, sids, tokens):
        out = pd.paged_decode_forward(params, cfg, dims, cache, sids, tokens)
        top2 = torch.topk(out[0], 2, dim=-1).values
        for bi, sid in enumerate(sids):
            last[sid] = (float(top2[bi, 0] - top2[bi, 1]),
                         MODEL_REL * float(out[0][bi, :v].abs().max()))
        return out

    eng, handles = serve.build_engine(cpu_args, params, decode_fn=decode_fn)
    for h in handles:
        h.on_token = lambda h, tok: margins.setdefault(h.rid, []).append(
            last[h.sid])
    eng.run_until_done(max_rounds=cpu_args.max_rounds)
    differ = 0
    for gh, ch in zip(run["handles"], handles):
        if gh.state.value != ch.state.value or len(gh.tokens) != len(
                ch.tokens):
            raise AssertionError(f"rid {gh.rid}: the card's request ended "
                                 f"otherwise than the CPU's")
        diff = [i for i, (a, b) in enumerate(zip(gh.tokens, ch.tokens))
                if a != b]
        differ += len(diff)
        if diff:
            margin, bar = margins[ch.rid][diff[0]]
            if margin > 2 * bar:
                raise AssertionError(
                    f"rid {gh.rid}: token {diff[0]} differs from the CPU's "
                    f"where the CPU's top-2 margin {margin} exceeds twice "
                    f"the bar {bar}")
    return dict(logits_max_abs_err=logits_err,
                logits_rows=len(snap["sids"]),
                snapshot_compressed_pages=int(
                    (snap["cache"].page_state == 0).sum()),
                tokens_differing_from_cpu=differ,
                cpu_tokens=eng.stats["tokens"])


# ------------------------------------------------------------ phase 10
# the port's other three model families at the full width of their
# configs (src/repro/configs/): mamba2-130m (24 Mamba2 layers, d_model
# 768, 24 SSD heads of 64, d_state 128, chunk 128, vocab 50280, tied),
# zamba2-7b (13 groups of 5 Mamba2 layers and the shared attention + MLP,
# then 3 Mamba2 layers: d_model 3584, d_ff 14336, 112 SSD heads of 64,
# d_state 64, 32 attention heads of 112) and seamless-m4t-large-v2 (24
# encoder and 24 decoder layers, d_model 1024, 16 heads of 64, d_ff 8192,
# vocab 256206), f32 params and compute, random weights from a seeded
# `torch.Generator` on the card; depth not cut.
SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH = ("mamba2-130m", "zamba2-7b",
                                      "seamless-m4t-large-v2")
SSM_B, SSM_S, SSM_PREFIX = 2, 512, 384   # 128 decode steps after 384
HYBRID_B, HYBRID_S, HYBRID_DECODE = 1, 512, 4
ENCDEC_B, ENCDEC_T, ENCDEC_DECODE = 2, 300, 8   # 300 frames: ragged keys


def family_model(torch, name, seed):
    """(cfg, dims, family module, params) of `name` at full width, f32,
    params drawn on the card from a generator seeded with `seed`."""
    from repro_torch.common.config import get_arch
    from repro_torch.models.api import get_model
    from repro_torch.models.dims import make_dims
    cfg = get_arch(name)
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    mod = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, dims, mod, mod.init(gen, cfg, dims, "cuda")


def kernel_launches(fn):
    """`fn()` and the F and E launches it made: (out, {name: count})."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    before = (ssd.LAUNCHES, fa.LAUNCHES)
    out = fn()
    return out, {"mamba2_ssd": ssd.LAUNCHES - before[0],
                 "flash_attention": fa.LAUNCHES - before[1]}


def decode_chain(torch, mod, params, cfg, dims, state, toks, pos0):
    """`decode_step` over `toks` [B, n] from `state` at positions pos0..:
    the logits [B, n, V] and the host ms of each step (synchronized)."""
    logits, ms = [], []
    for t in range(toks.shape[1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, state = mod.decode_step(params, state, cfg, dims,
                                    token=toks[:, t], pos=pos0 + t)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(lg)
    return torch.stack(logits, 1), ms


def hold_trees(torch, got, want, what):
    """`held` on every leaf of two state trees of one structure."""
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    if flat_paths(got) != flat_paths(want):
        raise AssertionError(f"{what}: state trees differ")
    return {f"{what}/{path}": held(torch, a, b, f"{what} {path}")
            for path, a, b in zip(flat_paths(got), tree_leaves(got),
                                  tree_leaves(want))}


def model_ssm_path(torch, np):
    """mamba2-130m through `repro_torch.models.mamba`: `prefill` of
    2 x 512 tokens, and of 2 x 384 followed by 128 `decode_step`s. Kernel
    F is every layer's chunked SSD (24 launches a prefill), with its
    final state handed to decode."""
    cfg, dims, M, params = family_model(torch, SSM_ARCH, 0)
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                       (SSM_B, SSM_S))).cuda()
    batch = {"tokens": toks}
    (logits, _), n512 = kernel_launches(lambda: M.prefill(params, batch,
                                                          cfg, dims))
    (h, states), _ = kernel_launches(lambda: M.forward(
        params, cfg, dims, tokens=toks, mode="prefill"))
    prefix = {"tokens": toks[:, :SSM_PREFIX]}
    (lg384, st384), n384 = kernel_launches(lambda: M.prefill(
        params, prefix, cfg, dims))
    step_logits, step_ms = decode_chain(torch, M, params, cfg, dims, st384,
                                        toks[:, SSM_PREFIX:], SSM_PREFIX)
    prefill_ms = time_cuda(torch, lambda i: M.prefill(params, batch, cfg,
                                                      dims), 3)
    profiles = {
        "prefill_512": device_share(torch, lambda: M.prefill(
            params, batch, cfg, dims)),
        "decode_step": device_share(torch, lambda: M.decode_step(
            params, st384, cfg, dims, token=toks[:, SSM_PREFIX],
            pos=SSM_PREFIX))}
    return dict(cfg=cfg, dims=dims, M=M, params=params, toks=toks,
                logits=logits, h=h, states=states, lg384=lg384,
                st384=st384, step_logits=step_logits,
                launches={"512": n512, "384": n384}), dict(
        phase="model_ssm_ssd", model=SSM_ARCH, dtype="float32",
        layers=cfg.n_layers, d_model=cfg.d_model,
        ssd=[dims.ssm_heads, cfg.ssm.head_dim, cfg.ssm.d_state,
             cfg.ssm.chunk], vocab=cfg.vocab_size,
        prefill_shapes=[[SSM_B, SSM_S], [SSM_B, SSM_PREFIX]],
        ssd_launches_a_prefill={"512": n512["mamba2_ssd"],
                                "384": n384["mamba2_ssd"]},
        prefill_ms=prefill_ms, decode_steps=SSM_S - SSM_PREFIX,
        decode_ms_a_step=sum(step_ms[1:]) / (len(step_ms) - 1),
        decode_ms_first_step=step_ms[0], profiles=profiles)


def check_model_ssm(torch, run):
    """The mamba path held: the 512-token forward's hidden states and
    every layer's decode state, and the 384-token prefill's logits and
    states, against the same calls with the plain SSD in F's place; the
    128 decode logits against the forward's logits at those positions;
    the last logits against a CPU run of the same prefill. F launched
    once a layer in each prefill."""
    from repro_torch.common.treeutil import tree_map
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.models.loss import logits_for
    cfg, dims, M, params = run["cfg"], run["dims"], run["M"], run["params"]
    toks = run["toks"]
    for k, n in run["launches"].items():
        if n["mamba2_ssd"] != cfg.n_layers:
            raise AssertionError(f"mamba prefill {k}: {n['mamba2_ssd']} "
                                 f"SSD launches, not one a layer")
    v = cfg.vocab_size
    errs = {}
    with plain_ssd(ssd):
        h, states = M.forward(params, cfg, dims, tokens=toks,
                              mode="prefill")
        lg384, st384 = M.prefill(params, {"tokens": toks[:, :SSM_PREFIX]},
                                 cfg, dims)
    errs["hidden_512"] = held(torch, run["h"], h, "mamba hidden 512")
    errs.update(hold_trees(torch, run["states"], states, "state_512"))
    errs["logits_384"] = held(torch, run["lg384"][:, :v], lg384[:, :v],
                              "mamba prefill 384 logits")
    errs.update(hold_trees(torch, run["st384"], st384, "state_384"))
    want = logits_for(run["h"][:, SSM_PREFIX:].reshape(-1, cfg.d_model),
                      params["embed"].T, v)
    errs["decode_logits"] = held(
        torch, run["step_logits"].reshape(-1, dims.vocab)[:, :v],
        want[:, :v], "mamba decode logits vs forward")
    cpu = tree_map(lambda x: x.cpu(), params)
    lg_cpu, _ = M.prefill(cpu, {"tokens": toks.cpu()}, cfg, dims)
    errs["logits_512_card_vs_cpu"] = held(torch, run["logits"][:, :v],
                                          lg_cpu[:, :v],
                                          "mamba logits, card vs CPU")
    return errs


def hybrid_decode_state(torch, M, cfg, dims, pre, batch, kv_len):
    """`init_decode_state` of `kv_len` filled with a prefill's state."""
    st = M.init_decode_state(cfg, dims, batch, kv_len, "cuda")
    s = pre["k"].shape[2]
    st["k"][:, :, :s] = pre["k"]
    st["v"][:, :, :s] = pre["v"]
    st["groups_mamba"] = pre["groups_mamba"]
    st["tail_mamba"] = pre["tail_mamba"]
    return st


def model_hybrid_path(torch, np):
    """zamba2-7b through `repro_torch.models.hybrid`: `prefill` of 1 x 512
    tokens (kernel F in each of the 68 Mamba layers, kernel E, causal
    with head dim 112, in each of the 13 applications of the shared
    attention), then 4 `decode_step`s."""
    from repro_torch.common.treeutil import tree_bytes
    cfg, dims, M, params = family_model(torch, HYBRID_ARCH, 1)
    rs = np.random.RandomState(1)
    toks = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (HYBRID_B, HYBRID_S + HYBRID_DECODE))).cuda()
    batch = {"tokens": toks[:, :HYBRID_S]}
    (logits, pre), n = kernel_launches(lambda: M.prefill(params, batch, cfg,
                                                         dims))
    (h, _), _ = kernel_launches(lambda: M.forward(
        params, cfg, dims, tokens=batch["tokens"], mode="prefill"))
    st = hybrid_decode_state(torch, M, cfg, dims, pre, HYBRID_B,
                             HYBRID_S + HYBRID_DECODE)
    step_logits, step_ms = decode_chain(torch, M, params, cfg, dims, st,
                                        toks[:, HYBRID_S:], HYBRID_S)
    prefill_ms = time_cuda(torch, lambda i: M.prefill(params, batch, cfg,
                                                      dims), 3)
    profile = device_share(torch, lambda: M.prefill(params, batch, cfg,
                                                    dims))
    groups, per, tail = M._split(cfg)
    return dict(cfg=cfg, dims=dims, M=M, params=params, toks=toks,
                logits=logits, pre=pre, h=h, step_logits=step_logits,
                launches=n), dict(
        phase="model_hybrid", model=HYBRID_ARCH, dtype="float32",
        blocks=cfg.n_layers, groups=groups, mamba_a_group=per,
        tail=tail, d_model=cfg.d_model, d_ff=cfg.d_ff,
        ssd=[dims.ssm_heads, cfg.ssm.head_dim, cfg.ssm.d_state,
             cfg.ssm.chunk],
        heads=[cfg.attention.n_heads, cfg.attention.n_kv_heads,
               cfg.attention.head_dim], vocab=cfg.vocab_size,
        param_bytes=tree_bytes(params),
        prefill_shape=[HYBRID_B, HYBRID_S], launches_a_prefill=n,
        prefill_ms=prefill_ms, decode_steps=HYBRID_DECODE,
        decode_ms_a_step=sum(step_ms[1:]) / (len(step_ms) - 1),
        decode_ms_first_step=step_ms[0],
        profiles={"prefill_512": profile})


def check_model_hybrid(torch, run):
    """The hybrid path held against the same calls with the plain SSD and
    the plain attention on the card: the prefill's logits, hidden states
    and every state leaf (each Mamba layer's, the shared attention's K/V
    of each group), and the 4 decode steps' logits from each run's own
    state. F once a Mamba layer, E once a group, in the prefill."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    cfg, dims, M, params = run["cfg"], run["dims"], run["M"], run["params"]
    groups, per, tail = M._split(cfg)
    want = {"mamba2_ssd": groups * per + tail, "flash_attention": groups}
    if run["launches"] != want:
        raise AssertionError(f"hybrid prefill: launches {run['launches']}, "
                             f"not {want}")
    toks, v = run["toks"], cfg.vocab_size
    with plain_ssd(ssd), plain_attention(fa):
        logits, pre = M.prefill(params, {"tokens": toks[:, :HYBRID_S]}, cfg,
                                dims)
        h, _ = M.forward(params, cfg, dims, tokens=toks[:, :HYBRID_S],
                         mode="prefill")
    st = hybrid_decode_state(torch, M, cfg, dims, pre, HYBRID_B,
                             HYBRID_S + HYBRID_DECODE)
    step_logits, _ = decode_chain(torch, M, params, cfg, dims, st,
                                  toks[:, HYBRID_S:], HYBRID_S)
    errs = {"logits": held(torch, run["logits"][:, :v], logits[:, :v],
                           "hybrid prefill logits"),
            "hidden": held(torch, run["h"], h, "hybrid hidden")}
    errs.update(hold_trees(torch, run["pre"], pre, "state"))
    errs["decode_logits"] = held(torch, run["step_logits"][..., :v],
                                 step_logits[..., :v],
                                 "hybrid decode logits")
    return errs


def model_encdec_path(torch, np):
    """seamless-m4t-large-v2 through `repro_torch.models.encdec`: frame
    embeddings [2, 300, 1024] from a seed, the BOS `prefill` (kernel E in
    every attention: 24 encoder self-attentions, non-causal 300 x 300; 24
    decoder self-attentions, causal 1 x 1; 24 cross-attentions,
    non-causal 1 x 300: 72 launches), then 8 `decode_step`s."""
    from repro_torch.common.treeutil import tree_bytes
    cfg, dims, M, params = family_model(torch, ENCDEC_ARCH, 2)
    g = torch.Generator(device="cuda").manual_seed(3)
    enc = torch.randn((ENCDEC_B, ENCDEC_T, cfg.d_model), generator=g,
                      device="cuda")
    rs = np.random.RandomState(2)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                       (ENCDEC_B, ENCDEC_DECODE))).cuda()
    batch = {"enc_embeds": enc}
    (logits, pre), n = kernel_launches(lambda: M.prefill(params, batch, cfg,
                                                         dims))
    enc_h, n_enc = kernel_launches(lambda: M.encode(params, cfg, dims, enc))
    st = M.init_decode_state(cfg, dims, ENCDEC_B, 1 + ENCDEC_DECODE,
                             enc_len=ENCDEC_T, device="cuda")
    for k in ("k", "v"):
        st[k][:, :, :1] = pre[k]
    st["ck"], st["cv"] = pre["ck"], pre["cv"]
    step_logits, step_ms = decode_chain(torch, M, params, cfg, dims, st,
                                        toks, 1)
    prefill_ms = time_cuda(torch, lambda i: M.prefill(params, batch, cfg,
                                                      dims), 3)
    profile = device_share(torch, lambda: M.prefill(params, batch, cfg,
                                                    dims))
    return dict(cfg=cfg, dims=dims, M=M, params=params, enc=enc, toks=toks,
                logits=logits, pre=pre, enc_h=enc_h, step_logits=step_logits,
                launches=n, encoder_launches=n_enc), dict(
        phase="model_encdec_flash", model=ENCDEC_ARCH, dtype="float32",
        encoder_layers=cfg.n_encoder_layers, decoder_layers=cfg.n_layers,
        d_model=cfg.d_model, d_ff=cfg.d_ff,
        heads=[cfg.attention.n_heads, cfg.attention.n_kv_heads,
               cfg.attention.head_dim], vocab=cfg.vocab_size,
        param_bytes=tree_bytes(params),
        enc_embeds=[ENCDEC_B, ENCDEC_T, cfg.d_model],
        flash_launches_a_prefill=n["flash_attention"],
        flash_launches_encoder=n_enc["flash_attention"],
        prefill_ms=prefill_ms, decode_steps=ENCDEC_DECODE,
        decode_ms_a_step=sum(step_ms[1:]) / (len(step_ms) - 1),
        decode_ms_first_step=step_ms[0],
        profiles={"prefill_bos": profile})


def check_model_encdec(torch, run):
    """The encoder-decoder path held against the same calls with the plain
    attention in E's place on the card: the encoder's output, the BOS
    prefill's logits and decode state (self and cross K/V of every
    layer), and the 8 decode steps' logits from each run's own state. E
    launched 72 times in the prefill, 24 of them in the encoder."""
    from repro_torch.kernels import flash_attention as fa
    cfg, dims, M, params = run["cfg"], run["dims"], run["M"], run["params"]
    want = 2 * cfg.n_layers + cfg.n_encoder_layers
    if (run["launches"]["flash_attention"] != want
            or run["encoder_launches"]["flash_attention"]
            != cfg.n_encoder_layers):
        raise AssertionError(f"encdec prefill: {run['launches']} launches "
                             f"({run['encoder_launches']} in the encoder), "
                             f"not {want} ({cfg.n_encoder_layers})")
    v = cfg.vocab_size
    with plain_attention(fa):
        logits, pre = M.prefill(params, {"enc_embeds": run["enc"]}, cfg,
                                dims)
        enc_h = M.encode(params, cfg, dims, run["enc"])
    st = M.init_decode_state(cfg, dims, ENCDEC_B, 1 + ENCDEC_DECODE,
                             enc_len=ENCDEC_T, device="cuda")
    for k in ("k", "v"):
        st[k][:, :, :1] = pre[k]
    st["ck"], st["cv"] = pre["ck"], pre["cv"]
    step_logits, _ = decode_chain(torch, M, params, cfg, dims, st,
                                  run["toks"], 1)
    errs = {"encoder": held(torch, run["enc_h"], enc_h, "encoder output"),
            "logits": held(torch, run["logits"][:, :v], logits[:, :v],
                           "encdec prefill logits")}
    errs.update(hold_trees(torch, run["pre"], pre, "state"))
    errs["decode_logits"] = held(torch, run["step_logits"][..., :v],
                                 step_logits[..., :v],
                                 "encdec decode logits")
    return errs


# ------------------------------------------------------------ phase 11
# training on the card: one `make_train_step` step at full width, f32,
# qwen2-0.5b (phase 9's model; batch 2 x 512, `accum` 1 and 2) and
# mamba2-130m (phase 10's; 2 x 512), from `SyntheticLMData(seed=0)`; then
# the trainer's checkpoint engine at the reference's bench shape.
TRAIN_B, TRAIN_S = 2, 512
TRAIN_CASES = ((MODEL_ARCH, 1), (MODEL_ARCH, 2), (SSM_ARCH, 1))
#: the leaves whose gradient passes through kernel E (attention q/k/v) or
#: kernel F (the Mamba x projection, whose gradient stays finite at full
#: width; `check_model_train`): non-zero, and held
THROUGH_KERNELS = {"dense": ("layers/attn/wq", "layers/attn/wk",
                             "layers/attn/wv"),
                   "ssm": ("layers/wx",)}


def plain_train(fa, ssd, ops):
    """A context in which the models' differentiable card routes
    (`ops.flash_attention_ragged_trainable`,
    `ops.mamba2_ssd_with_state_trainable`) are their plain versions
    differentiated by autograd, with `plain_attention` and `plain_ssd`
    besides: the step then runs its same code with no kernel, forward or
    backward, which holds E's and F's forward and the Functions' shared
    backward at once."""
    import contextlib
    from unittest import mock

    def attention(q, k, v, causal=True):
        return ops.R.flash_attention(q, k, v, causal=causal)

    def ssd_route(x, dt, A, B_in, C_in, *, chunk=128):
        return ops.R.mamba2_ssd_with_state(x, dt, A, B_in, C_in,
                                           chunk=chunk)
    stack = contextlib.ExitStack()
    stack.enter_context(plain_attention(fa))
    stack.enter_context(plain_ssd(ssd))
    stack.enter_context(mock.patch.object(
        ops, "flash_attention_ragged_trainable", attention))
    stack.enter_context(mock.patch.object(
        ops, "mamba2_ssd_with_state_trainable", ssd_route))
    return stack


def train_case(torch, name, accum):
    """(cfg, dims, state, batch) of one full-width training case on the
    card: params from a generator seeded 0, AdamW state, batch 0 of
    `SyntheticLMData(seed=0)`."""
    from repro_torch.common.config import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.train import make_state
    cfg = get_arch(name)
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = make_state(gen, cfg, dims, ocfg, device="cuda")
    batch = SyntheticLMData(cfg.vocab_size, batch=TRAIN_B, seq=TRAIN_S,
                            seed=0).batch_at(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    return cfg, dims, ocfg, state, batch


def model_train_path(torch, np):
    """One `make_train_step` step of each `TRAIN_CASES` entry, and the
    same step's gradients (`make_grad_fn`), with the E and F launches of
    each; ms a step, tokens/s and the device's busy share."""
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    from repro_torch.train import make_train_step
    from repro_torch.train.step import make_grad_fn
    runs, report = {}, {}
    for name, accum in TRAIN_CASES:
        label = f"{name}_accum{accum}"
        cfg, dims, ocfg, state, batch = train_case(torch, name, accum)
        grads_of = make_grad_fn(cfg, dims, accum=accum)
        (loss, _, grads), n_grad = kernel_launches(
            lambda: grads_of(state["params"], batch))
        step = make_train_step(cfg, dims, ocfg, accum=accum, device="cuda")
        (new_state, metrics), n_step = kernel_launches(
            lambda: step(state, batch))
        nonfinite = [path for path, x in zip(flat_paths(new_state),
                                             tree_leaves(new_state))
                     if not bool(torch.isfinite(x).all())]
        if nonfinite and cfg.family != "ssm":
            raise AssertionError(f"train step {label}: non-finite leaves "
                                 f"{nonfinite}")
        ms = time_cuda(torch, lambda i: step(state, batch), 3)
        runs[label] = dict(cfg=cfg, dims=dims, ocfg=ocfg, accum=accum,
                           state=state, batch=batch, loss=loss, grads=grads,
                           step_loss=metrics["loss"], n_grad=n_grad,
                           n_step=n_step)
        if (name, accum) == SHARDED_CASE:      # held by sharded_train_step
            runs[label]["new"] = {k: new_state[k] for k in ("params",)}
            runs[label]["new"]["m"] = new_state["opt"]["m"]
        report[label] = dict(
            model=name, accum=accum, batch=[TRAIN_B, TRAIN_S],
            layers=cfg.n_layers, d_model=cfg.d_model,
            loss=float(metrics["loss"]),
            gnorm=(float(metrics["gnorm"]) if bool(torch.isfinite(
                metrics["gnorm"])) else str(float(metrics["gnorm"]))),
            step_ms=ms, tokens_per_s=TRAIN_B * TRAIN_S / (ms / 1e3),
            launches_a_step=n_step, launches_in_grads=n_grad,
            nonfinite_state_leaves=len(nonfinite),
            profile=device_share(torch, lambda: step(state, batch)))
        del new_state, metrics
        torch.cuda.empty_cache()
    return runs, dict(phase="model_train_step", dtype="float32",
                      cases=report)


def held_nonfinite(torch, got, want, what, rel=MODEL_REL):
    """`held` on the elements where `want` is finite; where it is not,
    `got` must hold the same value (NaN where NaN, the same infinity).
    Returns (max abs difference, count of non-finite elements)."""
    g, w = got.float(), want.float().to(got.device)
    bad = ~torch.isfinite(w)
    same = torch.equal(bad, ~torch.isfinite(g)) and torch.equal(
        torch.isnan(w), torch.isnan(g)) and torch.equal(
        g[bad & ~torch.isnan(w)], w[bad & ~torch.isnan(w)])
    if not same:
        raise AssertionError(f"{what}: the non-finite elements differ")
    if bool(bad.all()):
        return 0.0, int(bad.sum())
    return held(torch, g[~bad], w[~bad], what, rel), int(bad.sum())


def check_model_train(torch, run):
    """Each case's loss and every gradient leaf against the same call
    with no kernel (`plain_train`), at `MODEL_REL` of the plain leaf's
    largest magnitude; the leaves through E or F (`THROUGH_KERNELS`)
    non-zero; E launched twice a layer and microbatch (forward and the
    rematerialized forward), F twice a Mamba layer.

    mamba2-130m's gradients hold NaN at full width, in the reference as
    here: the chunked SSD's within-chunk decay exp(cum_i - cum_j)
    overflows above the diagonal (|dt·A| summed over 128 tokens passes
    88), and the masked product's gradient is 0·inf (`ROADMAP.md` queue
    3). Its leaves are held where finite, with NaN at the same elements
    in both calls, and F's input x (whose gradient stays finite) must
    carry a finite non-zero gradient to `layers/wx`."""
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops
    from repro_torch.train.step import make_grad_fn
    errs = {}
    for label, r in run.items():
        cfg = r["cfg"]
        kernel = ("mamba2_ssd" if cfg.family == "ssm" else
                  "flash_attention")
        want = 2 * cfg.n_layers * r["accum"]
        for what in ("n_grad", "n_step"):
            if r[what][kernel] != want:
                raise AssertionError(f"{label}: {r[what][kernel]} {kernel} "
                                     f"launches in {what}, not {want}")
        grads_of = make_grad_fn(cfg, r["dims"], accum=r["accum"])
        with plain_train(fa, ssd, ops):
            (loss, _, grads), n = kernel_launches(
                lambda: grads_of(r["state"]["params"], r["batch"]))
        if any(n.values()):
            raise AssertionError(f"{label}: the plain step launched {n}")
        errs[f"{label}/loss"] = held(torch, r["loss"], loss, f"{label} loss")
        errs[f"{label}/step_loss"] = held(torch, r["step_loss"], loss,
                                          f"{label} step loss")
        paths = flat_paths(grads)
        got = dict(zip(flat_paths(r["grads"]), tree_leaves(r["grads"])))
        ssm = cfg.family == "ssm"
        for path, w in zip(paths, tree_leaves(grads)):
            what = f"{label} gradient {path}"
            if ssm:
                err, n_bad = held_nonfinite(torch, got[path], w, what)
                errs[f"{label}/grad/{path}"] = err
                if n_bad:
                    errs[f"{label}/nan_elements/{path}"] = n_bad
            else:
                errs[f"{label}/grad/{path}"] = held(torch, got[path], w,
                                                    what)
        for path in THROUGH_KERNELS["ssm" if ssm else "dense"]:
            g = got[path][torch.isfinite(got[path])]
            if g.numel() == 0 or float(g.abs().max()) == 0.0:
                raise AssertionError(f"{label}: no finite gradient reaches "
                                     f"{path} through the kernel")
    return errs


#: `model_train_step`'s case that `sharded_train_step` runs sharded
SHARDED_CASE = (MODEL_ARCH, 1)


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def param_bar(torch, m, p, lr, rel=MODEL_REL):
    """The bar on a param after a first AdamW step whose gradient
    x = m / (1 - b1) is held at `rel`: the step moves an element by
    lr·x/(|x| + eps), so a difference d = `rel`·max|x| in x moves it by
    up to lr·min(2, d·eps/(max(|x| - d, 0) + eps)²) (nothing where |x| is
    well above d, up to 2·lr at roundoff level), plus `rel` of the
    leaf's largest |p|."""
    x = m.float().abs() / 0.1
    d = rel * float(x.max())
    eps = 1e-8
    move = torch.clamp_max(d * eps / (torch.clamp_min(x - d, 0.0) + eps) ** 2,
                           2.0)
    return lr * move + rel * float(p.float().abs().max())


def sharded_train_path(torch, np, train_run):
    """`model_train_step`'s qwen2-0.5b case (2 x 512, accum 1, f32)
    through the whole sharded API on a world of one card: an NCCL
    process group at tcp://127.0.0.1:<free port>, `make_host_mesh`,
    `launch.specs.to_shardings` of the train specs, the state and batch
    distributed as DTensors, `sharding_context` active (every `shd`, E
    through `local_map`), then `make_grad_fn` and one `make_train_step`
    step. Held against that case's unsharded run: the loss, every
    gradient leaf and m after the step at `MODEL_REL`, params after the
    step within `param_bar`; E 2 a layer in each call, as unsharded;
    every gradient in its param's placements. The group is destroyed at
    the end, and the card is left with no group."""
    import torch.distributed as dist
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import (LOGICAL_RULES_SINGLE_POD,
                                               distribute, full,
                                               sharding_context)
    from repro_torch.train import make_train_step
    from repro_torch.train.step import make_grad_fn
    r = train_run["%s_accum%d" % SHARDED_CASE]
    cfg, dims, ocfg = r["cfg"], r["dims"], r["ocfg"]
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    errs, placements = {}, {}
    try:
        mesh = make_host_mesh(1, device="cuda")
        t_init = time.perf_counter() - t0
        with sharding_context(mesh, LOGICAL_RULES_SINGLE_POD, set()):
            _, specs = SP.state_shapes_and_specs(cfg, dims, "train", None)
            state = distribute(r["state"], SP.to_shardings(mesh, specs))
            batch = distribute(r["batch"], SP.to_shardings(
                mesh, SP.batch_spec_axes(cfg, r["batch"])))
            grads_of = make_grad_fn(cfg, dims)
            (loss, _, grads), n_grad = kernel_launches(
                lambda: grads_of(state["params"], batch))
            step = make_train_step(cfg, dims, ocfg, device="cuda")
            (new, metrics), n_step = kernel_launches(
                lambda: step(state, batch))
            ms = time_cuda(torch, lambda i: step(state, batch), 3)
            want = 2 * cfg.n_layers
            for what, n in (("grads", n_grad), ("step", n_step)):
                if n["flash_attention"] != want:
                    raise AssertionError(
                        f"sharded {what}: {n['flash_attention']} E "
                        f"launches, not {want} as unsharded")
            errs["loss"] = held(torch, full(loss), r["loss"], "sharded loss")
            errs["step_loss"] = held(torch, full(metrics["loss"]),
                                     r["step_loss"], "sharded step loss")
            got = dict(zip(flat_paths(grads), tree_leaves(grads)))
            params = dict(zip(flat_paths(state["params"]),
                              tree_leaves(state["params"])))
            for path, w in zip(flat_paths(r["grads"]),
                               tree_leaves(r["grads"])):
                g = got[path]
                if list(g.placements) != list(params[path].placements):
                    raise AssertionError(f"sharded gradient {path}: "
                                         f"placements {g.placements}, "
                                         f"param {params[path].placements}")
                placements[path] = [str(x) for x in g.placements]
                errs[f"grad/{path}"] = held(torch, full(g), w,
                                            f"sharded gradient {path}")
            new_m = dict(zip(flat_paths(new["opt"]["m"]),
                             tree_leaves(new["opt"]["m"])))
            for path, w in zip(flat_paths(r["new"]["m"]),
                               tree_leaves(r["new"]["m"])):
                errs[f"m/{path}"] = held(torch, full(new_m[path]), w,
                                         f"sharded m {path}")
            new_p = dict(zip(flat_paths(new["params"]),
                             tree_leaves(new["params"])))
            lr = float(full(metrics["lr"]))
            for path, w, m in zip(flat_paths(r["new"]["params"]),
                                  tree_leaves(r["new"]["params"]),
                                  tree_leaves(r["new"]["m"])):
                err = (full(new_p[path]).float() - w.float()).abs()
                bar = param_bar(torch, m, w, lr)
                if not bool((err <= bar).all()):
                    raise AssertionError(f"sharded param {path}: "
                                         f"{float((err - bar).max())} over "
                                         f"its bar")
                errs[f"param/{path}"] = float(err.max())
            mesh_shape = list(mesh.shape)
    finally:
        dist.destroy_process_group()
    if dist.is_initialized() or torch.cuda.device_count() < 1:
        raise AssertionError("a process group outlived sharded_train_step")
    return errs, dict(
        phase="sharded_train_step", model=SHARDED_CASE[0],
        batch=[TRAIN_B, TRAIN_S], accum=1, dtype="float32",
        world=1, backend="nccl", mesh=dict(zip(("data", "model"),
                                               mesh_shape)),
        launches_in_grads=n_grad, launches_a_step=n_step,
        unsharded_launches_a_step=r["n_step"], step_ms=ms,
        group_init_s=round(t_init, 3), loss=float(full(loss)),
        grad_placements_sample={k: placements[k] for k in list(placements)[:4]},
        tolerance=f"MODEL_REL={MODEL_REL} of the unsharded leaf's largest "
                  f"magnitude (loss, gradients, m); params within "
                  f"param_bar")


def trainer_ckpt_path(torch, np):
    """The trainer and its checkpoint engine on the card:
    `bench_darp_ckpt` at `run.py --fast`'s 20 steps (reduced qwen2.5-3b,
    8 x 64 tokens; E in every step), a bit-exact round trip of a CUDA
    train state with bf16 moments and a factored second moment, and
    `python -m repro_torch.launch.train --reduced --steps 12` in a process
    of its own."""
    import tempfile
    sys.path.insert(0, HERE)
    from benchmarks_torch import bench_framework as BF
    from repro_torch.checkpoint import CheckpointConfig, CheckpointEngine
    from repro_torch.common.config import get_arch
    from repro_torch.common.treeutil import tree_leaves
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.train import make_state, make_train_step
    t0 = time.perf_counter()
    bench = BF.bench_darp_ckpt(steps=20, device="cuda")
    bench_s = time.perf_counter() - t0
    want = load_artifact("darp_ckpt")
    for k in want:
        require_same(bench[k]["flushes"], want[k]["flushes"],
                     f"darp_ckpt {k} flushes")
    cfg = get_arch("qwen2.5-3b").reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig(moment_dtype="bfloat16", factored_v=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    state = make_state(gen, cfg, dims, ocfg, device="cuda")
    rs = np.random.RandomState(3)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (4, 32)),
             "labels": rs.randint(0, cfg.vocab_size, (4, 32))}
    state, _ = make_train_step(cfg, dims, ocfg, device="cuda")(state, batch)
    with tempfile.TemporaryDirectory() as d:
        eng = CheckpointEngine(CheckpointConfig(directory=d, interval=1,
                                                n_banks=3))
        eng.force_snapshot(1, state)
        eng.flush_all_now()
        eng.wait()
        restored, step = eng.restore(state)
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
             "--steps", "12", "--device", "cuda", "--ckpt-dir",
             os.path.join(d, "cli"), "--ckpt-interval", "4"],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    if cli.returncode != 0:
        raise AssertionError(f"launch.train exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    if step != 1:
        raise AssertionError(f"restored step {step}, not 1")
    n_bf16 = 0
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        if a.dtype != b.dtype or a.device != b.device:
            raise AssertionError("restored leaf of another dtype or device")
        if a.dtype == torch.bfloat16:
            n_bf16 += 1
            a, b = a.view(torch.int16), b.view(torch.int16)
        if not torch.equal(a, b):
            raise AssertionError("checkpoint round trip not bit-exact")
    if n_bf16 == 0:
        raise AssertionError("the round trip held no bf16 leaf")
    return dict(phase="trainer_ckpt", darp_ckpt=bench,
                darp_ckpt_seconds=bench_s,
                flushes_equal_reference=True,
                round_trip={"leaves": len(tree_leaves(state)),
                            "bf16_leaves": n_bf16, "bit_exact": True},
                launch_train_cli=cli.stdout.strip().splitlines()[:1]
                + cli.stdout.strip().splitlines()[-1:])


#: the dry run held on the card: `model_train_step`'s cases at accum 1
DRYRUN_ARCHS = (MODEL_ARCH, SSM_ARCH)


def plain_route(layers):
    """A context in which the models' card routes (`_flash_on_card`,
    `_ssd_on_card`) are the plain route that CPU and `meta` tensors take
    (`chunked_attention_plain`, `ssd_chunked_plain`): a step on the card
    then dispatches the same aten ops as the dry run counts on `meta`."""
    import contextlib
    from unittest import mock

    def attention(q, k, v, *, causal, q_offset):
        return layers.chunked_attention_plain(q, k, v, causal=causal,
                                              q_offset=q_offset)
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(layers, "_flash_on_card",
                                          attention))
    stack.enter_context(mock.patch.object(layers, "_ssd_on_card",
                                          layers.ssd_chunked_plain))
    return stack


def dryrun_path(torch, np):
    """The one-card dry run held on the card, for qwen2-0.5b and
    mamba2-130m at `model_train_step`'s 2 x 512, f32, accum 1:
    (a) `launch.specs.state_shapes_and_specs`' `meta` leaves equal, leaf
    for leaf in shape and dtype, the state `make_state` builds on the
    card; (b) `analyze_ops` of the train step on `meta` counts exactly
    the FLOPs and product FLOPs of the same step on the card with the
    plain route patched in (`plain_route`), and the same step through
    kernels E and F counts fewer: their ctypes launches are invisible to
    a dispatch mode; (c) the step's measured ms (CUDA events, and the
    device's busy ms under `torch.profiler`) on each route beside the dry
    run's `bound_s`, the share of the bound each reaches."""
    from repro_torch.common.config import ShapeConfig
    from repro_torch.common.treeutil import tree_leaves
    from repro_torch.launch import specs as SP
    from repro_torch.models import layers
    from repro_torch.parallel.op_analysis import analyze_ops
    from repro_torch.train import make_train_step
    report = {}
    for name in DRYRUN_ARCHS:
        cfg, dims, ocfg, state, batch = train_case(torch, name, 1)
        shape = ShapeConfig("model_train_step", TRAIN_S, TRAIN_B, "train")
        meta_state, _ = SP.state_shapes_and_specs(cfg, dims, "train", shape)
        sig = [(tuple(x.shape), x.dtype) for x in tree_leaves(meta_state)]
        if sig != [(tuple(x.shape), x.dtype) for x in tree_leaves(state)]:
            raise AssertionError(f"dryrun {name}: the meta state's leaves "
                                 f"differ from make_state's on the card")
        meta_batch = {k: torch.empty_like(v, device="meta")
                      for k, v in batch.items()}
        meta = analyze_ops(make_train_step(cfg, dims, ocfg, device="meta"),
                           meta_state, meta_batch)
        step = make_train_step(cfg, dims, ocfg, device="cuda")
        with plain_route(layers):
            card_plain = analyze_ops(step, state, batch)
            plain_ms = time_cuda(torch, lambda i: step(state, batch), 3)
            plain_prof = device_share(torch, lambda: step(state, batch))
        card_kernels = analyze_ops(step, state, batch)
        kernels_ms = time_cuda(torch, lambda i: step(state, batch), 3)
        kernels_prof = device_share(torch, lambda: step(state, batch))
        for what in ("flops", "dot_flops"):
            if getattr(meta, what) != getattr(card_plain, what):
                raise AssertionError(
                    f"dryrun {name}: {what} on meta {getattr(meta, what)} "
                    f"!= on the card's plain route "
                    f"{getattr(card_plain, what)}")
        if not card_kernels.dot_flops < card_plain.dot_flops:
            raise AssertionError(f"dryrun {name}: the kernel route counts "
                                 f"no fewer product FLOPs")
        roof = meta.roofline()
        bound_ms = 1e3 * roof["bound_s"]
        report[name] = dict(
            batch=[TRAIN_B, TRAIN_S], dtype="float32",
            state_leaves=len(sig), meta_leaves_equal_card=True,
            meta=dict(flops=meta.flops, dot_flops=meta.dot_flops,
                      hbm_bytes=meta.hbm_bytes, ops=meta.n_instructions),
            card_plain_route=dict(flops=card_plain.flops,
                                  dot_flops=card_plain.dot_flops,
                                  hbm_bytes=card_plain.hbm_bytes,
                                  ops=card_plain.n_instructions),
            card_kernel_route=dict(flops=card_kernels.flops,
                                   dot_flops=card_kernels.dot_flops,
                                   hbm_bytes=card_kernels.hbm_bytes,
                                   ops=card_kernels.n_instructions),
            flops_equal=True, roofline=roof, bound_ms=bound_ms,
            plain_route=dict(step_ms=plain_ms, profile=plain_prof,
                             bound_share=bound_ms / plain_ms),
            kernel_route=dict(step_ms=kernels_ms, profile=kernels_prof,
                              bound_share=bound_ms / kernels_ms))
        del state
        torch.cuda.empty_cache()
    return dict(phase="dryrun", note="bound_ms is the dry run's bound of "
                "the plain route's ops (meta); E and F are invisible to "
                "its count on the kernel route", cases=report)


#: one arch a family: every applicable shape of each runs in the dry
#: run's matrix here (`python -m repro_torch.launch.dryrun` runs all ten;
#: the MoE family's other arch, qwen3-moe-235b-a22b, has 94 layers and
#: alone would take twice as long)
DRYRUN_FAMILY_ARCHS = (MODEL_ARCH, "llama4-maverick-400b-a17b", SSM_ARCH,
                       HYBRID_ARCH, ENCDEC_ARCH)


def dryrun_runs(runs, phase):
    """`python -m repro_torch.launch.dryrun ARGS` for each ARGS of `runs`,
    all started together (the cells run on `meta`, on the host's cores),
    into a temporary directory: one JSON line a cell (`phase`), and the
    records; a cell that is not `ok`, or a run that does not exit 0,
    fails."""
    import glob
    import tempfile
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", tmp], cwd=HERE, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for args in runs]
        logs = [p.communicate()[0] for p in procs]
        for args, p, log in zip(runs, procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"dryrun {' '.join(args)} exited "
                                     f"{p.returncode}:\n{log[-2000:]}")
        for path in sorted(glob.glob(os.path.join(tmp, "*.json"))):
            with open(path) as f:
                rec = json.load(f)
            if not rec["ok"]:
                raise AssertionError(f"dryrun cell {rec['arch']} "
                                     f"{rec['shape']} {rec['mesh']}: "
                                     f"{rec.get('error')}")
            line = {k: rec[k] for k in ("arch", "shape", "mesh", "ok",
                                        "devices", "analyze_s",
                                        "fits_one_card", "roofline",
                                        "roofline_fraction")}
            line["memory_gb"] = {k: rec["memory"][k] for k in (
                "argument_gb", "output_gb")}
            if rec["devices"] > 1:
                line["collective_counts"] = rec["ops"]["collective_counts"]
                line["wire_bytes_per_dev"] = rec["ops"]["wire_bytes_per_dev"]
                line["collective_links"] = rec["ops"]["collective_links"]
            emit(dict(phase=phase, **line))
            out.append(rec)
    return out


def dryrun_matrix(archs):
    """The one-card dry run of every shape of each of `archs`
    (`--one-card-only`, one process an arch)."""
    return dryrun_runs([["--arch", arch, "--one-card-only"]
                        for arch in archs], "dryrun_cell")


#: the production meshes' dry run on this machine's torch (`dryrun_pods`):
#: the reference's own test cell, decode_32k, and a train cell
DRYRUN_POD_SHAPES = ("decode_32k", "train_4k")


def dryrun_pods_path():
    """`python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape S`
    for each S of `DRYRUN_POD_SHAPES`, both started together, on every
    mesh: one card, and the reference's (data=16, model=16) and (pod=2,
    data=16, model=16) in fake worlds of 256 and 512 ranks (on `meta`:
    no device work, and no card set a rank). DTensor's op coverage
    differs between torch releases, so this is the run that shows that
    this machine's torch runs them. Every record `ok`; train_4k's with
    all-gathers and all-reduces; a production record's arguments a
    device at least the one-card record's over its devices and at most
    the one-card record's. One line a cell, with its host seconds."""
    recs = dryrun_runs([["--arch", MODEL_ARCH, "--shape", s]
                        for s in DRYRUN_POD_SHAPES], "dryrun_pod_cell")
    by = {(r["shape"], r["mesh"]): r for r in recs}
    for shape in DRYRUN_POD_SHAPES:
        one = by[(shape, "h100x1")]["memory"]["argument_gb"]
        for mesh, devices in (("pod16x16", 256), ("pod2x16x16", 512)):
            rec = by[(shape, mesh)]
            what = f"dryrun_pods {shape} {mesh}"
            if rec["devices"] != devices:
                raise AssertionError(f"{what}: {rec['devices']} devices")
            arg = rec["memory"]["argument_gb"]
            if not one / devices <= arg <= one:
                raise AssertionError(f"{what}: {arg} GB of arguments a "
                                     f"device, one card's {one}")
            cc = rec["ops"]["collective_counts"]
            if shape.startswith("train") and not (
                    cc.get("all-gather", 0) > 0 and cc.get("all-reduce", 0)
                    > 0):
                raise AssertionError(f"{what}: collectives {cc}")
    return dict(phase="dryrun_pods", arch=MODEL_ARCH,
                shapes=list(DRYRUN_POD_SHAPES), cells=len(recs),
                analyze_s={f"{r['shape']}__{r['mesh']}": r["analyze_s"]
                           for r in recs})


def time_family_kernels(torch):
    """F and E at the shapes the three family paths give them, beside
    their plain versions, bounds and, for E, SDPA (CUDA events; these
    launches are not counted): F with its final state (the model route)
    at mamba2-130m's [2, 512, 24, 64] N=128 and zamba2-7b's
    [1, 512, 112, 64] N=64, chunk 128; E in float32 at the encoder's
    [32, 300, 64] non-causal (ragged: `flash_attention_ragged`) and at
    zamba2's shared attention [32, 512, 112] causal. Each time is held
    against its plain version first."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    g = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for name, (b, s, h, p, n) in (("mamba2_130m", (2, 512, 24, 64, 128)),
                                  ("zamba2_7b", (1, 512, 112, 64, 64))):
        args = ssd_inputs(torch, g, b, s, h, p, n)
        y, st = ssd.mamba2_ssd_with_state(*args, chunk=SSD_CHUNK)
        yw, stw = ssd.mamba2_ssd_with_state_torch(*args, chunk=SSD_CHUNK)
        err = max(close(torch, y, yw, *SSD_TOL, f"ssd {name} y"),
                  close(torch, st, stw, *SSD_TOL, f"ssd {name} state"))
        fl = ssd.operations(b, s, h, p, n, SSD_CHUNK)
        # x, dt, A, B, C read once; y and the final state written once
        nbytes = 4 * (2 * args[0].numel() + args[1].numel() + h
                      + 2 * args[3].numel() + st.numel())
        (ms, b_by), how = min(
            (bound(nbytes, fl, FP32_FLOPS), "float32 CUDA cores"),
            (bound(nbytes, 3 * fl, TF32_TC_FLOPS), "3xTF32 tensor cores"))
        out[f"mamba2_ssd_{name}"] = dict(
            x=[b, s, h, p], d_state=n, chunk=SSD_CHUNK, with_state=True,
            max_abs_err=err, operations=fl, bytes=nbytes,
            ms=time_cuda(torch, lambda i: ssd.mamba2_ssd_with_state(
                *args, chunk=SSD_CHUNK), 50, stall_ms=5),
            plain_ms=time_cuda(torch, lambda i:
                               ssd.mamba2_ssd_with_state_torch(
                                   *args, chunk=SSD_CHUNK), 10, stall_ms=5),
            bound_ms=ms, bound_by=b_by, bound_note=how, library_ms=None)
    for name, (bh, sq, d, causal) in (
            ("encoder_300", (32, ENCDEC_T, 64, False)),
            ("zamba2_shared_512", (32, HYBRID_S, 112, True))):
        a = [torch.randn((bh, sq, d), generator=g, device="cuda")
             for _ in range(3)]
        fn = flash_entry(fa, sq, sq)
        err = close(torch, fn(*a, causal=causal),
                    fa.flash_attention_torch(*a, causal=causal),
                    *FLASH_TOL["float32"], f"flash {name}")
        fl = fa.operations(bh, sq, sq, d, causal, ragged=True)
        nbytes = 4 * a[0].numel() * 4
        (ms, b_by), how = min(
            (bound(nbytes, fl, FP32_FLOPS), "float32 CUDA cores"),
            (bound(nbytes, 3 * fl, TF32_TC_FLOPS), "3xTF32 tensor cores"))
        out[f"flash_attention_{name}"] = dict(
            shape=[bh, sq, d], dtype="float32", causal=causal,
            entry=fn.__name__, max_abs_err=err, operations=fl,
            ms=time_cuda(torch, lambda i: fn(*a, causal=causal), 50,
                         stall_ms=5),
            plain_ms=time_cuda(torch, lambda i: fa.flash_attention_torch(
                *a, causal=causal), 20, stall_ms=5),
            library_ms=time_cuda(torch, lambda i:
                                 F.scaled_dot_product_attention(
                                     *[x[None] for x in a],
                                     is_causal=causal), 50, stall_ms=5),
            bound_ms=ms, bound_by=b_by, bound_note=how)
    return out


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

    # 0. contract: the port's static checks, before anything is built
    from repro_torch.analysis import RepoContext, run_passes
    contract = run_passes(RepoContext(HERE))
    emit({"phase": "contract", "findings": len(contract.findings),
          "suppressed": len(contract.suppressed),
          "seconds": round(time.perf_counter() - t_start, 3)})
    if contract.findings:
        raise AssertionError("contract findings:\n" + "\n".join(
            map(str, contract.findings)))

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
        for name in filter(None, expects.split("+")):
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
    t_model = time.perf_counter()
    model_run, mp = drive("model_prefill_flash", "flash_attention",
                          model_prefill_path, torch, np)
    mp["max_abs_err"] = check_model_prefill(torch, model_run)
    mp["seconds"] = round(time.perf_counter() - t_model, 3)
    emit(dict(mp, launches=paths["model_prefill_flash"]))
    del model_run
    t_serve = time.perf_counter()
    serve_run, se = drive("serve_engine", "kv_quant", serve_engine_path,
                          torch, np)
    se["held_against_cpu"] = check_serve_on_cpu(
        torch, serve_run, paths["serve_engine"]["kv_quant"])
    se["seconds_with_cpu_check"] = round(time.perf_counter() - t_serve, 3)
    emit(dict(se, launches=paths["serve_engine"]))
    del serve_run
    for label, expects, path, check in (
            ("model_ssm_ssd", "mamba2_ssd", model_ssm_path,
             check_model_ssm),
            ("model_hybrid", "mamba2_ssd+flash_attention",
             model_hybrid_path, check_model_hybrid),
            ("model_encdec_flash", "flash_attention", model_encdec_path,
             check_model_encdec)):
        t_path = time.perf_counter()
        run, rep = drive(label, expects, path, torch, np)
        rep["max_abs_err"] = check(torch, run)
        rep["seconds"] = round(time.perf_counter() - t_path, 3)
        emit(dict(rep, launches=paths[label]))
        del run
        torch.cuda.empty_cache()
    t_train = time.perf_counter()
    train_run, trs = drive("model_train_step", "flash_attention+mamba2_ssd",
                           model_train_path, torch, np)
    trs["max_abs_err"] = check_model_train(torch, train_run)
    trs["seconds"] = round(time.perf_counter() - t_train, 3)
    emit(dict(trs, launches=paths["model_train_step"]))
    t_shard = time.perf_counter()
    shard_errs, shs = drive("sharded_train_step", "flash_attention",
                            sharded_train_path, torch, np, train_run)
    shs["max_abs_err"] = max(shard_errs.values())
    shs["seconds"] = round(time.perf_counter() - t_shard, 3)
    emit(dict(shs, launches=paths["sharded_train_step"]))
    del train_run
    torch.cuda.empty_cache()
    t_ckpt = time.perf_counter()
    ckp = drive("trainer_ckpt", "flash_attention", trainer_ckpt_path, torch,
                np)
    ckp["seconds"] = round(time.perf_counter() - t_ckpt, 3)
    emit(dict(ckp, launches=paths["trainer_ckpt"]))
    t_dry = time.perf_counter()
    dry = drive("dryrun", "flash_attention+mamba2_ssd", dryrun_path, torch,
                np)
    dry["seconds"] = round(time.perf_counter() - t_dry, 3)
    emit(dict(dry, launches=paths["dryrun"]))
    t_pods = time.perf_counter()
    pods = drive("dryrun_pods", "", dryrun_pods_path)
    pods["seconds"] = round(time.perf_counter() - t_pods, 3)
    emit(dict(pods, launches=paths["dryrun_pods"]))
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
    tmk = time_model_kernels(torch)
    tf["model_paths"] = tmk
    tfam = time_family_kernels(torch)
    tf["family_paths"] = tfam
    emit({"phase": "timing", "arbiter": ta, "arbiter_paper_shape": ta_paper,
          "megakernel": tm, "megakernel_paper_grid": tm_paper,
          "open_megakernel": to, "open_megakernel_open_grid": to_grid, **tf,
          "seconds_total": round(time.perf_counter() - t_start, 1)})

    # the dry run's matrix on meta (no device work)
    t_matrix = time.perf_counter()
    cells = dryrun_matrix(DRYRUN_FAMILY_ARCHS)
    emit({"phase": "dryrun_matrix", "archs": list(DRYRUN_FAMILY_ARCHS),
          "cells": len(cells), "ok": len(cells),
          "seconds": round(time.perf_counter() - t_matrix, 1),
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
         "serving_page": tmk["kv_quant"],
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
         "model_path": {k: v for k, v in {**tmk, **tfam}.items()
                        if k.startswith("flash")},
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
         "model_paths": {k: v for k, v in tfam.items()
                         if k.startswith("mamba2_ssd")},
         "heads_per_block": ssd.HEADS_PER_BLOCK,
         "sass_HMMA": sass["ssd_HMMA"], "library_ms": None,
         "library_note": "PyTorch has no SSD scan"}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
