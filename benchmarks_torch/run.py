#!/usr/bin/env python3
"""Benchmark harness of the PyTorch/CUDA port: the DRAM half of
`benchmarks/run.py`, one entry per paper figure and sweep bench, then the
framework benches.

    python3 benchmarks_torch/run.py [--fast] [--device cuda|cpu] [--out DIR]

Prints ``name,us_per_call,derived`` CSV lines, as the reference does;
each entry's dict goes to ``DIR/<name>.json`` (default
`results/bench_torch/`), and `device.json` there records where the run
was made (the card's name and power limit as `nvidia-smi` gives them,
torch and CUDA versions, the flags).

  fig1  paper Fig.1: perf loss of REF_ab/REF_pb vs ideal across densities
  fig2  paper Fig.2: SARP service timeline (read behind refresh)
  fig3  paper Fig.3: DSARP perf+energy vs baselines
  sweep_grid          open 8x8x3 grid: batched vs the scalar tick oracle
                      and the legacy DramSim loop
  sweep_closed_loop   closed grid vs looping DramSim.run_ticks
  sweep_multirank     n_ranks in {1,2,4}, bit_identical per rank count
  sweep_subarray      n_subarrays in {1,4,8}, bit_identical per count
  sweep_mega          the CUDA megakernel's giga-sweep ladder vs the torch
                      tick body on the card, sharding probe, regression
                      guard vs batched on the 8x8x3 grid
  command_trace       command emission overhead, violations, round trip
  darp_ckpt           framework DARP: checkpoint flush scheduling overhead
                      of the trainer (reduced qwen2.5-3b)
  serving_policies    serving maintenance policies through the legacy
                      `ServingEngine` shim: tokens, stalls, compressions
  serving_lifecycle   `EngineCore` request lifecycle: TTFT/TPOT
                      percentiles under a mixed-prompt batch with chunked
                      prefill, the prefill/decode call split
  serving_cosim       serving <-> DRAM co-sim: tick-space TTFT/TPOT p99
                      orderings per refresh policy, the bit-identical pin
  sarp_decode_bytes   fused vs serial paged-attention HBM traffic
  kernel_micro        plain versions and kernels, us a call on the card

The figures sweep on `backend="mega"` on the card. With `--device cpu`
they sweep on the numpy `batched` engine (the megakernel's plain version
gives the same cells but is only a correctness oracle), the serving
entries run their engines on the CPU, and the two entries that time the
card, `sweep_mega` and `kernel_micro`, are left out (`darp_ckpt` trains
on the CPU there).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from benchmarks_torch import bench_framework as BF  # noqa: E402
from benchmarks_torch import fig_refresh as FR  # noqa: E402

RESULTS = os.path.join(ROOT, "results", "bench_torch")


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run.py")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)
    fast, device = args.fast, args.device
    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("run.py: torch.cuda.is_available() is False; pass --device "
              "cpu to run the host entries", file=sys.stderr)
        return 2
    backend = "mega" if on_card else "batched"
    os.makedirs(args.out, exist_ok=True)

    def emit(name, us, derived, payload):
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(payload, f, indent=1, default=str)
        print(f"{name},{us:.1f},{derived}", flush=True)

    info = {"device": device, "fast": fast, "torch": torch.__version__,
            "cuda": torch.version.cuda, "figure_backend": backend}
    if on_card:
        info["nvidia_smi"] = card_line()
        info["device_name"] = torch.cuda.get_device_name(0)
        print(info["nvidia_smi"], flush=True)
    with open(os.path.join(args.out, "device.json"), "w") as f:
        json.dump(info, f, indent=1)

    # the closed-loop demand must span several tREFI intervals or
    # all-bank refresh barely fires
    reqs = 800 if fast else 2000

    t0 = time.perf_counter()
    runs = FR.fig_grids(reqs=reqs, backend=backend, device=device)
    f1 = FR.fig1(reqs=reqs, runs=runs)
    emit("fig1_refresh_loss", (time.perf_counter() - t0) * 1e6,
         f"refpb_loss_32gb={f1[32]['ref_pb']:.3f};"
         f"refab_loss_32gb={f1[32]['ref_ab']:.3f}", f1)

    t0 = time.perf_counter()
    f2 = FR.fig2()
    emit("fig2_sarp_timeline", (time.perf_counter() - t0) * 1e6,
         f"refpb_p99={f2['ref_pb']['p99_read_ns']:.0f}ns;"
         f"sarp_p99={f2['sarp_pb']['p99_read_ns']:.0f}ns;"
         f"sarp_overlapped_serves="
         f"{f2['sarp_pb']['serves_during_sibling_refresh']}", f2)

    t0 = time.perf_counter()
    f3 = FR.fig3(reqs=reqs, runs=runs)
    emit("fig3_dsarp", (time.perf_counter() - t0) * 1e6,
         f"dsarp_impr_32gb={f3[32]['dsarp']['improvement_vs_refab']:.3f};"
         f"dsarp_energy_vs_refab={f3[32]['dsarp']['energy_vs_refab']:.3f}",
         f3)

    t0 = time.perf_counter()
    sg = FR.sweep_grid(fast=fast)
    emit("sweep_grid", (time.perf_counter() - t0) * 1e6,
         f"vs_dramsim_loop={sg['speedup_vs_dramsim_loop']}x;"
         f"vs_scalar_tick={sg['speedup_vs_scalar_tick']}x;"
         f"bit_identical={sg['bit_identical']}", sg)

    t0 = time.perf_counter()
    cl = FR.closed_loop(fast=fast)
    emit("sweep_closed_loop", (time.perf_counter() - t0) * 1e6,
         f"vs_dramsim_ticks={cl['speedup_vs_dramsim_ticks']}x;"
         f"bit_identical={cl['bit_identical']}", cl)

    t0 = time.perf_counter()
    mr = FR.sweep_multirank(fast=fast)
    ws2 = mr["per_rank_count"][2]["weighted_speedup_vs_ideal"]
    emit("sweep_multirank", (time.perf_counter() - t0) * 1e6,
         f"bit_identical={mr['bit_identical']};"
         f"dsarp_ws_2rank_32gb={ws2['dsarp'][32]};"
         f"refab_ws_2rank_32gb={ws2['ref_ab'][32]}", mr)

    t0 = time.perf_counter()
    ss = FR.sweep_subarray(fast=fast)
    ws8 = ss["per_subarray_count"][8]["weighted_speedup_vs_ideal"]
    emit("sweep_subarray", (time.perf_counter() - t0) * 1e6,
         f"bit_identical={ss['bit_identical']};"
         f"sarp_ws_8sub_32gb={ws8['sarp_pb'][32]};"
         f"refpb_ws_8sub_32gb={ws8['ref_pb'][32]}", ss)

    if on_card:
        t0 = time.perf_counter()
        sm = FR.sweep_mega(fast=fast, device=device)
        top = sm["ladder"][-1]
        emit("sweep_mega", (time.perf_counter() - t0) * 1e6,
             f"cells={top['cells']};"
             f"mega_cells_per_s={top['mega_cells_per_s']};"
             f"vs_torch={top['speedup_vs_torch']}x;"
             f"fused_beats_batched="
             f"{sm['ref_grid_8x8x3']['fused_beats_batched']};"
             f"bit_identical={sm['bit_identical']}", sm)

    t0 = time.perf_counter()
    ct = FR.command_trace(fast=fast)
    emit("command_trace", (time.perf_counter() - t0) * 1e6,
         f"overhead_pct={ct['overhead_pct']};"
         f"violations={ct['violations']};"
         f"bit_identical={ct['bit_identical']}", ct)

    ck = BF.bench_darp_ckpt(steps=20 if fast else 40, device=device)
    emit("darp_ckpt", ck["darp"]["mean_step_ms"] * 1e3,
         f"darp_overhead={ck['darp']['overhead_pct']}%;"
         f"sync_overhead={ck['all_bank']['overhead_pct']}%", ck)

    t0 = time.perf_counter()
    sv = BF.bench_serving(n_requests=4 if fast else 6,
                          max_new=12 if fast else 24,
                          policies=FR.SERVING_POLICIES, device=device)
    emit("serving_policies", (time.perf_counter() - t0) * 1e6,
         f"darp_stalls={sv['darp']['forced_stalls']};"
         f"allbank_stalls={sv['all_bank']['forced_stalls']};"
         f"darp_tps={sv['darp']['tok_per_s']}", sv)

    t0 = time.perf_counter()
    sl = BF.bench_serving_lifecycle(n_requests=4 if fast else 6,
                                    max_new=8 if fast else 12,
                                    device=device)
    emit("serving_lifecycle", (time.perf_counter() - t0) * 1e6,
         f"darp_ttft_p50_ms={sl['darp']['ttft']['p50_ms']};"
         f"darp_tpot_p50_ms={sl['darp']['tpot']['p50_ms']};"
         f"prefill_calls={sl['darp']['prefill_calls']};"
         f"decode_calls={sl['darp']['decode_calls']}", sl)

    t0 = time.perf_counter()
    # fast mode trims the policy sweep, not the request count: the p99
    # orderings only stabilize at a few hundred requests
    sc = BF.bench_serving_cosim(
        n_requests=200, scenario="serving_bursty",
        policies=(("darp", "all_bank") if fast
                  else ("dsarp", "darp", "ref_pb", "all_bank")),
        device=device)
    emit("serving_cosim", (time.perf_counter() - t0) * 1e6,
         f"ttft_p99_ordered={sc['ttft_p99_ordered']};"
         f"tpot_p99_ordered={sc['tpot_p99_ordered']};"
         f"stall_ordered={sc['stall_ordered']};"
         f"bit_identical={sc['bit_identical']};"
         f"darp_ttft_p99={sc['darp']['ttft_ticks']['p99']};"
         f"allbank_ttft_p99={sc['all_bank']['ttft_ticks']['p99']}", sc)

    sb = BF.bench_sarp_bytes()
    emit("sarp_decode_bytes", 0.0,
         f"serial_over_fused={sb['serial_over_fused']:.1f}x;"
         f"bf16_over_fused={sb['bf16_over_fused']:.1f}x", sb)

    if on_card:
        km = BF.bench_kernel_micro(device=device)
        emit("kernel_micro", km["flash_ref_us"],
             f"ssd={km['ssd_ref_us']}us;quant={km['kv_quant_us']}us;"
             f"flash_kernel={km['flash_kernel_us']}us;"
             f"ssd_kernel={km['ssd_kernel_us']}us;"
             f"quant_kernel={km['kv_quant_kernel_us']}us", km)
    else:
        print("run.py: sweep_mega and kernel_micro time the card; left out "
              "with --device cpu", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
