"""Kernels A1 and A2's design choices, measured: build the two tick-loop
megakernel sources (`csrc/sweep_megakernel.cu`, `csrc/sweep_megakernel_
open.cu`) and variants of them side by side, hold each against its plain
version on conformance grids of both modes (difference 0), time each at
the four main-path shapes - the closed paper grid (seed 1, 120 cells), the
open reference grid (192 cells) and the closed and open 1e5 ladder rungs
(100128 cells) - with CUDA events (3 calls, one run each), sweep the
cells a block of the kept design at each shape, and read a clock64
profile of a group's tick by phase. Run on a machine with an NVIDIA GPU
and nvcc: `python3 benchmarks_torch/mega_variants.py`; one JSON object a
line, the card's name and power limit first.

A variant is a list of (text, replacement) patches of the two sources:

  final    the sources as they are: a group of G lanes a cell, G the
           smallest power of two covering the banks and cores, at least 8;
  thread   one thread a cell (G = 1): the lane owns all 8 banks and 4
           cores, walks them in turn, and keeps the state in registers and
           shared memory as the group does - the one-thread design of the
           first port without its global scratch;
  g16      groups of 16 lanes at 8 banks (half of them idle);
  g32      groups of 32 lanes at 8 banks: a warp a cell;
  profile  `final` with clock64 probes: per tick of every group, the
           cycles of lane 0 in closed phases 0, 1, 2-3 (with the queue
           heads), 4 and 5, and open phases A, B, C and D, summed in
           registers and added to a device array when the cell ends;
  profile_g32  the same probes in `g32`;
  shfl_reduce  group reductions below 32 lanes as `__shfl_xor_sync`
           butterflies: with a lane mask known only at run time the
           compiler wraps each `__reduce_*_sync` in a loop over the
           distinct masks of the warp (MATCH, then REDUX per mask).

The patches choose the instantiation that 8-bank cells run (the only
shape of the four); each variant is compiled by its own `nvcc` (all at
once) into `build/mega_variants/<name>/` and loaded with ctypes in place
of the package's library while it runs. Its patches are text of the
sources: edit them with the sources."""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.core.policy import list_policies
from repro_torch.core.refresh.scenarios import make_closed_demand, make_trace
from repro_torch.core.sweep import SweepSpec
from repro_torch.core.sweep.engine import _Grid
from repro_torch.kernels import _build
from repro_torch.kernels import sweep_megakernel as mega

CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
CLOSED, OPEN = "sweep_megakernel.cu", "sweep_megakernel_open.cu"
TICK = "sweep_tick.cuh"


def instantiation(closed_args, open_args):
    """Patches that run 8-bank cells on another instantiation."""
    return [(CLOSED, "if (m <= 8) return f(ClosedKernel<8, 1, 1>{});",
             f"if (m <= 8) return f(ClosedKernel<{closed_args}>{{}});"),
            (OPEN, "if (B <= 8) return f(OpenKernel<8, 1>{});",
             f"if (B <= 8) return f(OpenKernel<{open_args}>{{}});")]


PROF_HEAD = (
    "__device__ unsigned long long g_prof_{m}[8];\n"
    "#define g_prof g_prof_{m}\n"
    "extern \"C\" int read_prof_{m}(unsigned long long* h) {{\n"
    "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}}\n"
    "extern \"C\" int zero_prof_{m}() {{\n"
    "  unsigned long long z[8] = {{0}};\n"
    "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}}\n")
PROF_FLUSH = ("    if (g.lane == 0)\n"
              "      for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], pr[i]);"
              "\n")
PROFILE = [
    (CLOSED, "#define SWEEP_WIDE (", PROF_HEAD.format(m="closed")
     + "#define SWEEP_WIDE ("),
    (CLOSED, "    int t = 0;\n    while (active && t < m.P.horizon) {\n",
     "    int t = 0;\n    unsigned long long pr[8] = {0};\n"
     "    while (active && t < m.P.horizon) {\n"
     "      long long p0 = clock64();\n"),
    (CLOSED, "      // ---- 1: core issue,",
     "      long long p1 = clock64();\n      // ---- 1: core issue,"),
    (CLOSED, "      // queue depths after this tick's appends, and the "
             "heads\n",
     "      long long p2 = clock64();\n"
     "      // queue depths after this tick's appends, and the heads\n"),
    (CLOSED, "      // ---- 4: refresh decisions\n",
     "      long long p3 = clock64();\n      // ---- 4: refresh decisions\n"),
    (CLOSED, "      // ---- 5: occupancy-aware arbitration",
     "      long long p4 = clock64();\n"
     "      // ---- 5: occupancy-aware arbitration"),
    (CLOSED, "      if (parked) g.sync();  // parked returns visible to the "
             "cores' lanes\n    }\n",
     "      if (parked) g.sync();  // parked returns visible to the "
     "cores' lanes\n"
     "      long long p5 = clock64();\n"
     "      pr[0] += p1 - p0; pr[1] += p2 - p1; pr[2] += p3 - p2;\n"
     "      pr[3] += p4 - p3; pr[4] += p5 - p4; pr[5] += 1;\n    }\n"
     + PROF_FLUSH),
    (OPEN, "#define SWEEP_WIDE (", PROF_HEAD.format(m="open")
     + "#define SWEEP_WIDE ("),
    (OPEN, "    int t = 0;\n    // the cell is active while it has requests "
           "left to serve\n    while (served < n_tot && t < m.P.horizon) {\n",
     "    int t = 0;\n    unsigned long long pr[8] = {0};\n"
     "    while (served < n_tot && t < m.P.horizon) {\n"
     "      long long p0 = clock64();\n"),
    (OPEN, "      // ---- B: per-rank refresh debt\n",
     "      long long p1 = clock64();\n"
     "      // ---- B: per-rank refresh debt\n"),
    (OPEN, "      // ---- C: refresh decisions",
     "      long long p2 = clock64();\n      // ---- C: refresh decisions"),
    (OPEN, "      // ---- D: arbitration + serve",
     "      long long p3 = clock64();\n      // ---- D: arbitration + serve"),
    (OPEN, "      m.writes_served(n_ws);\n      t += 1;\n    }\n",
     "      m.writes_served(n_ws);\n      t += 1;\n"
     "      long long p4 = clock64();\n"
     "      pr[0] += p1 - p0; pr[1] += p2 - p1; pr[2] += p3 - p2;\n"
     "      pr[3] += p4 - p3; pr[5] += 1;\n    }\n" + PROF_FLUSH)]

def butterfly(op, combine):
    """A group reduction as log2(G) `__shfl_xor_sync` steps below 32 lanes
    in place of `__reduce_<op>_sync`."""
    call = f"__reduce_{op}_sync(mask, v"
    old = (f"if constexpr (G == 1) return v; else return {call});"
           if op != "add" else
           f"if constexpr (G == 1) return v;\n    else return (int){call[:-1]}"
           f"(unsigned)v);")
    new = ("if constexpr (G == 1) return v;\n"
           "    else if constexpr (G < 32) {\n"
           "      for (int o = G / 2; o > 0; o >>= 1) {\n"
           "        const int u = __shfl_xor_sync(mask, v, o, G);\n"
           f"        v = {combine};\n      }}\n      return v;\n"
           f"    }} {old[len('if constexpr (G == 1) return v;'):].strip()}")
    return (TICK, old, new)


SHFL_REDUCE = [butterfly("max", "u > v ? u : v"),
               butterfly("min", "u < v ? u : v"), butterfly("add", "u + v")]
VARIANTS = {"final": [], "thread": instantiation("1, 8, 8", "1, 8"),
            "g16": instantiation("16, 1, 1", "16, 1"),
            "g32": instantiation("32, 1, 1", "32, 1"), "profile": PROFILE,
            "profile_g32": PROFILE + instantiation("32, 1, 1", "32, 1"),
            "shfl_reduce": SHFL_REDUCE}
CLOSED_PHASES = ("0_completions", "1_issue", "2_3_heads_debt",
                 "4_refresh_decide", "5_arbitrate_serve")
OPEN_PHASES = ("A_arrivals", "B_debt", "C_refresh_decide",
               "D_arbitrate_serve")


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(name, patches):
    """Start nvcc on the patched sources (and the arbiter source, for its
    error strings); returns (library path, process)."""
    out = os.path.join(HERE, "build", "mega_variants", name)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "sweep_fields.h"), "w") as f:
        f.write(_build._fields_header())
    srcs = []
    for fname in (CLOSED, OPEN, "sweep_arbiter.cu", TICK):
        src = open(os.path.join(CSRC, fname)).read()
        for target, a, b in patches:
            if target != fname:
                continue
            if src.count(a) != 1:
                raise RuntimeError(f"variant {name}: patch text found "
                                   f"{src.count(a)} times in {fname}: "
                                   f"{a[:60]!r}")
            src = src.replace(a, b)
        path = os.path.join(out, fname)
        with open(path, "w") as f:
            f.write(src)
        if fname.endswith(".cu"):
            srcs.append(path)
    so = os.path.join(out, "lib.so")
    return so, subprocess.Popen(
        [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", out, "-I", CSRC,
         "-shared", "-o", so, *srcs], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


SASS_OPS = ("WARPSYNC", "BSSY", "BSYNC", "VOTE", "REDUX", "SHFL", "MATCH",
            "LDS", "STS", "LDG", "STG", "RED")


def sass_ops(so):
    """Per megakernel function of a library: its SASS instruction count
    and how many of those are warp collectives, convergence barriers and
    memory operations (`cuobjdump -sass`)."""
    tool = os.path.join(os.path.dirname(_build._find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            fn = name if "sweep_mega" in name else None
            if fn:
                out[fn] = dict.fromkeys(("instructions",) + SASS_OPS, 0)
            continue
        if fn is None or "/*" not in line or ";" not in line:
            continue
        op = line.split("*/", 1)[1].split(";")[0].split()
        op = [w for w in op if not w.startswith("@")]
        if not op:
            continue
        out[fn]["instructions"] += 1
        head = op[0].split(".")[0]
        if head in SASS_OPS:
            out[fn][head] += 1
    return out


def bind(lib):
    """The megakernels' C interface (as `_build._bind` declares it)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sweep_mega_closed_launch.argtypes = [p] * 14 + [i] * 15 + [p]
    lib.sweep_mega_closed_plan.argtypes = [i] * 10 + [p]
    lib.sweep_mega_open_launch.argtypes = [p] * 11 + [i] * 11 + [p]
    lib.sweep_mega_open_plan.argtypes = [i] * 8 + [p]
    for fn in ("closed_launch", "closed_plan", "open_launch", "open_plan"):
        getattr(lib, f"sweep_mega_{fn}").restype = i
    lib.sweep_error_string.argtypes = [i]
    lib.sweep_error_string.restype = ctypes.c_char_p
    return lib


def shapes(policies):
    """The four main-path shapes, as (name, spec)."""
    return [
        ("paper_seed1", SweepSpec(
            policies=cs.FIG3_POLICIES, scenarios=cs.CLOSED_FIG_SCENARIOS,
            densities=cs.DENSITIES, reqs=2000, seed=1, mode="closed")),
        ("open_grid", SweepSpec(
            policies=cs.GRID_POLICIES, scenarios=cs.GRID_SCENARIOS,
            densities=cs.DENSITIES, reqs=cs.OPEN_REQS, seed=0)),
        ("closed_ladder", cs.ladder_spec(SweepSpec, make_closed_demand,
                                         policies, cs.LADDER_SCENARIOS)),
        ("open_ladder", cs.open_ladder_spec(SweepSpec, make_trace, policies,
                                            cs.LADDER_SCENARIOS))]


def kernel_run(cfg, inputs, threads=None):
    run = mega.mega_closed_cells if cfg.closed else mega.mega_open_cells
    return run(cfg, *inputs, threads=threads)


def differs(got, want):
    return any(not torch.equal(a, b) for a, b in zip(got, want)
               if b is not None)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    procs = {name: build(name, p) for name, p in VARIANTS.items()}
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        emit({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "sweep_mega" in ln or "registers" in ln or "spill" in ln]})
        libs[name] = bind(ctypes.CDLL(so))
        if name in ("final", "g32"):
            emit({"variant": name, "sass": sass_ops(so)})
    package_lib = _build.load()

    policies = tuple(list_policies())
    checks = [("conformance", cs.conformance_specs(SweepSpec, policies)[0][1]),
              ("subarray_s4", cs.conformance_specs(SweepSpec, policies)[3][1]),
              ("open_conformance",
               cs.open_conformance_specs(SweepSpec, policies)[0][1]),
              ("open_subarray_s4",
               cs.open_conformance_specs(SweepSpec, policies)[3][1])]
    timed = [(name, spec, _Grid(spec))
             for name, spec in shapes(policies)]
    try:
        for gname, spec in checks:
            cfg, _, *inputs = mega.device_inputs(
                _Grid(spec), "cuda")
            plain = (mega._plain_closed_cells if cfg.closed
                     else mega._plain_open_cells)(cfg, *inputs)
            for name, lib in libs.items():
                _build._lib = lib
                if differs(kernel_run(cfg, inputs), plain):
                    raise AssertionError(f"variant {name} differs from the "
                                         f"plain version on {gname}")
            emit({"grid": gname, "cells": int(inputs[0].shape[0]),
                  "variants_equal_to_plain": list(libs)})
        for sname, spec, grid in timed:
            cfg, _, *inputs = mega.device_inputs(grid, "cuda")
            row = {"shape": sname, "cells": grid.G}
            for name, lib in libs.items():
                _build._lib = lib
                plan = mega.launch_plan(cfg, grid.G, inputs[0].device)
                row[name] = dict(ms=cs.time_cuda(
                    torch, lambda i: kernel_run(cfg, inputs), 3),
                    G=plan["G"], cells_per_block=plan["cells_per_block"],
                    registers=plan["registers"])
            emit(row)
            _build._lib = libs["final"]
            sweep_row = {"shape": sname, "variant": "final",
                         "ms_by_cells_per_block": {}}
            for cells in (1, 2, 4, 8, 16, 32, 64):
                sweep_row["ms_by_cells_per_block"][cells] = cs.time_cuda(
                    torch, lambda i: kernel_run(cfg, inputs, cells), 3)
            sweep_row["rule_picks"] = mega._block_threads(
                grid.G, inputs[0].device)
            emit(sweep_row)
            for pname in ("profile", "profile_g32"):
                if sname not in ("paper_seed1", "open_grid"):
                    break
                lib = libs[pname]
                _build._lib = lib
                m = "closed" if cfg.closed else "open"
                getattr(lib, f"zero_prof_{m}")()
                kernel_run(cfg, inputs)
                torch.cuda.synchronize()
                h = np.zeros(8, np.uint64)
                getattr(lib, f"read_prof_{m}")(
                    h.ctypes.data_as(ctypes.c_void_p))
                ticks = max(int(h[5]), 1)
                names = CLOSED_PHASES if cfg.closed else OPEN_PHASES
                emit({"shape": sname, "variant": pname,
                      "profile_cell_ticks": int(h[5]),
                      "cycles_per_tick": dict(zip(
                          names, [round(float(x) / ticks, 1)
                                  for x in h[:len(names)]]))})
    finally:
        _build._lib = package_lib


if __name__ == "__main__":
    main()
