"""Kernel E's design choices, measured: build `csrc/flash_attention.cu`
and variants of it side by side, hold each against the plain version at
`chip_smoke.FLASH_CASES` (both types, causal and not, at `FLASH_TOL`),
time each at the Qwen2.5-14B prefill shape [40, 4096, 128] causal beside
`scaled_dot_product_attention` (CUDA events, two runs of 10 calls), and
read a clock64 profile of the tile loop. Run on a machine with an NVIDIA
GPU and nvcc: `python3 benchmarks_torch/flash_variants.py`; one JSON
object a line, the card's name and power limit first.

A variant is a list of (text, replacement) patches of the source:

  final      the source as it is;
  cvt_rna    TF32 rounding by `cvt.rna.tf32.f32`, which ptxas expands into
             compares and selects, in place of the two integer operations;
  kt64       bf16 kv tiles of 64 keys in place of 128;
  noswizzle  bf16 tiles in the no-swizzle core-matrix layout (8 rows x 16
             bytes a matrix), whose copies read eight half lines a warp;
  profile    the source with clock64 probes: per tile of the bf16 and f32
             kernels the cycles of a warpgroup's first thread in the copy
             issue (`prefetch`), the copy wait, the two block barriers and
             the compute, and per bf16 warpgroup tile in S = Q·Kᵀ (the
             copy issue included), softmax with the P split, and P·V.

Each variant is compiled by its own `nvcc` (all at once) into
`build/flash_variants/<name>/` and loaded with ctypes; the package's own
build is not touched."""
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
import torch.nn.functional as F

import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")

CVT_RNA = [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
            "  uint32_t y;\n"
            "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(y) : \"f\"(x));\n"
            "  return y;")]
KT64 = [("constexpr int BF_KT = 128;", "constexpr int BF_KT = 64;"),
        ("// s[0..63] += Q(64 x 16, smem) · K(16 x 128, smem)ᵀ",
         "__device__ __forceinline__ void wgmma_qk(float (&s)[32], "
         "uint64_t da, uint64_t db) {\n  asm volatile(\n"
         "      \"{\\n.reg .pred p;\\nsetp.ne.b32 p, %34, 0;\\n\"\n"
         "      \"wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 \"\n"
         "      \"{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
         "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
         "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\\n}\\n\"\n"
         "      : FA_F32(s, 0)\n      : \"l\"(da), \"l\"(db), \"r\"(1));\n"
         "}\n// s[0..63] += Q(64 x 16, smem) · K(16 x 128, smem)ᵀ")]
NOSWIZZLE = [
    ("         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);",
     "         ((uint64_t)(sbo >> 4) << 32);"),
    ("      const int c = i & 15, r = i >> 4;",
     "      const int c = (i >> 3) & 15, r = (i >> 7) * 8 + (i & 7);"),
    ("        cp_async16(dst + (c >> 3) * R * SW_ROW + r * SW_ROW +\n"
     "                       (((c & 7) ^ (r & 7)) << 4),",
     "        cp_async16(dst + (r >> 3) * 2048 + c * 128 + (r & 7) * 16,"),
    ("      const int c = i & 31, r = i >> 5, c16 = c >> 1;",
     "      const int c = (i >> 3) & 31, r = (i >> 8) * 8 + (i & 7), "
     "c16 = c >> 1;"),
    ("        cp_async8(dst + (c16 >> 3) * R * SW_ROW + r * SW_ROW +\n"
     "                      (((c16 & 7) ^ (r & 7)) << 4) + (c & 1) * 8,",
     "        cp_async8(dst + (r >> 3) * 2048 + c16 * 128 + (r & 7) * 16 "
     "+ (c & 1) * 8,"),
    ("        const uint32_t q0 = s_q + wg * 64 * SW_ROW;",
     "        const uint32_t q0 = s_q + wg * 8 * 2048;"),
    ("          wgmma_qk(s,\n"
     "                   wg_desc(q0 + (kk >> 2) * FA_BQ * SW_ROW + off, 16,\n"
     "                           SW_ATOM),\n"
     "                   wg_desc(k0 + (kk >> 2) * BF_KT * SW_ROW + off, 16,\n"
     "                           SW_ATOM));",
     "          (void)off;\n"
     "          wgmma_qk(s, wg_desc(q0 + kk * 256, 128, 2048),\n"
     "                   wg_desc(k0 + kk * 256, 128, 2048));"),
    ("        const uint64_t dv = wg_desc(s_v + st * BF_TILE_BYTES,\n"
     "                                    BF_KT * SW_ROW, SW_ATOM);",
     "        const uint64_t dv = wg_desc(s_v + st * BF_TILE_BYTES, 2048, "
     "128);"),
    ("          const uint64_t d = dv + kk * (2 * SW_ATOM >> 4);",
     "          const uint64_t d = dv + kk * (2 * 2048 >> 4);")]
PROFILE = [
    ("namespace {\n",
     "__device__ unsigned long long g_prof[16];\n"
     "extern \"C\" int read_prof(unsigned long long* h) {\n"
     "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}\n"
     "extern \"C\" int zero_prof() {\n"
     "  unsigned long long z[16] = {0};\n"
     "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n"
     "#define PROF_ADD(i, v) do { if ((threadIdx.x & 127) == 0) "
     "atomicAdd(&g_prof[i], (unsigned long long)(v)); } while (0)\n"
     "namespace {\n"),
    ("    cp_wait<0>();\n"
     "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
     "    __syncthreads();\n"
     "    compute(n & 1, n * KT, [&] {\n"
     "      if (n + 1 < n_tiles) load_kv((n + 1) & 1, (n + 1) * KT);\n"
     "    });\n"
     "    cp_commit();\n"
     "    __syncthreads();",
     "    long long t1 = clock64();\n"
     "    cp_wait<0>();\n"
     "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
     "    long long t2 = clock64();\n"
     "    __syncthreads();\n"
     "    long long t3 = clock64(), tp = 0;\n"
     "    compute(n & 1, n * KT, [&] {\n"
     "      long long a = clock64();\n"
     "      if (n + 1 < n_tiles) load_kv((n + 1) & 1, (n + 1) * KT);\n"
     "      tp += clock64() - a;\n"
     "    });\n"
     "    cp_commit();\n"
     "    long long t4 = clock64();\n"
     "    __syncthreads();\n"
     "    long long t5 = clock64();\n"
     "    PROF_ADD(0, tp); PROF_ADD(1, t2 - t1); PROF_ADD(2, t3 - t2);\n"
     "    PROF_ADD(3, t4 - t3); PROF_ADD(4, t5 - t4); PROF_ADD(5, 1);"),
    ("        float s[BF_KT / 2];",
     "        long long c0 = clock64();\n        float s[BF_KT / 2];"),
    ("        wg_wait();\n        fence_regs(s);\n",
     "        wg_wait();\n        fence_regs(s);\n"
     "        long long c1 = clock64();\n"),
    ("        fence_regs(o);\n        fence_regs(ph);",
     "        long long c2 = clock64();\n"
     "        fence_regs(o);\n        fence_regs(ph);"),
    ("        wg_commit();\n        wg_wait();\n        fence_regs(o);\n"
     "      });",
     "        wg_commit();\n        wg_wait();\n        fence_regs(o);\n"
     "        long long c3 = clock64();\n"
     "        PROF_ADD(8, c1 - c0); PROF_ADD(9, c2 - c1);\n"
     "        PROF_ADD(10, c3 - c2); PROF_ADD(11, 1);\n"
     "      });")]
VARIANTS = {"final": [], "cvt_rna": CVT_RNA, "kt64": KT64,
            "noswizzle": NOSWIZZLE, "profile": PROFILE}


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(name, patches):
    """Start nvcc on the patched source; returns (library path, process)."""
    src = open(os.path.join(CSRC, "flash_attention.cu")).read()
    for a, b in patches:
        if src.count(a) != 1:
            raise RuntimeError(f"variant {name}: patch text found "
                               f"{src.count(a)} times: {a[:60]!r}")
        src = src.replace(a, b)
    out = os.path.join(HERE, "build", "flash_variants", name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "flash_attention.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out, "lib.so")
    return so, subprocess.Popen(
        [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared",
         "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def launcher(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "bf16"):
        fn = getattr(lib, f"flash_attention_{dt}_launch")
        fn.argtypes, fn.restype = [p] * 4 + [i] * 7 + [p], i

    def run(q, k, v, causal):
        out = torch.empty_like(q)
        bh, sq, d = q.shape
        q_blk, kv_blk = fa.blocks(sq, k.shape[1])
        dt = "f32" if q.dtype == torch.float32 else "bf16"
        err = getattr(lib, f"flash_attention_{dt}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            sq, k.shape[1], d, q_blk, kv_blk, int(causal),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def worst_ratio(run):
    """Largest |got - want| / (atol + rtol |want|) over FLASH_CASES, by
    dtype: below 1 is within the bar."""
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = {}
    for case in cs.FLASH_CASES:
        q, k, v = cs.flash_inputs(torch, g, *case)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                a = [x.to(dtype) for x in (q, k, v)]
                got = run(*a, causal).float()
                want = fa.flash_attention_torch(*a, causal=causal).float()
                atol, rtol = cs.FLASH_TOL[cs.dtype_name(dtype)]
                r = float(((got - want).abs()
                           / (atol + rtol * want.abs())).max())
                worst[cs.dtype_name(dtype)] = max(
                    worst.get(cs.dtype_name(dtype), 0.0), r)
    return worst


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    procs = {name: build(name, patches) for name, patches in VARIANTS.items()}
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        emit({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "C75" in ln]})
        libs[name] = ctypes.CDLL(so)
    runs = {name: launcher(lib) for name, lib in libs.items()}
    for name, run in runs.items():
        emit({"variant": name, "worst_ratio_to_bar": worst_ratio(run)})
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = [torch.randn((cs.QWEN_H, cs.PREFILL_S, cs.QWEN_D), generator=g,
                       device="cuda") for _ in range(3)]
    for dt in (torch.bfloat16, torch.float32):
        a = [x.to(dt) for x in qkv]
        row = {"dtype": cs.dtype_name(dt), "shape": list(a[0].shape),
               "sdpa_ms": [cs.time_cuda(torch, lambda i: (
                   F.scaled_dot_product_attention(
                       *[x[None] for x in a], is_causal=True)), 10)
                   for _ in range(2)]}
        for name, run in runs.items():
            row[f"{name}_ms"] = [cs.time_cuda(
                torch, lambda i: run(*a, True), 10) for _ in range(2)]
        emit(row)
        lib = libs["profile"]
        lib.zero_prof.argtypes, lib.zero_prof.restype = [], ctypes.c_int
        lib.read_prof.argtypes = [ctypes.c_void_p]
        lib.read_prof.restype = ctypes.c_int
        lib.zero_prof()
        runs["profile"](*a, True)
        torch.cuda.synchronize()
        h = np.zeros(16, np.uint64)
        lib.read_prof(h.ctypes.data_as(ctypes.c_void_p))
        tiles = max(int(h[5]), 1)
        prof = {"dtype": cs.dtype_name(dt), "tiles": int(h[5]),
                "cycles_per_tile": dict(zip(
                    ("prefetch_issue", "copy_wait", "barrier_before",
                     "compute", "barrier_after"),
                    [round(float(x) / tiles, 1) for x in h[:5]]))}
        if h[11]:
            prof["cycles_per_warpgroup_tile"] = dict(zip(
                ("S_with_prefetch", "softmax_and_split", "PV"),
                [round(float(x) / float(h[11]), 1) for x in h[8:11]]))
        emit(prof)


if __name__ == "__main__":
    main()
