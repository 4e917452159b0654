"""Kernel C's design choices, measured: build `csrc/refresh_paged_attention.cu`,
variants of it and the first port's design side by side, hold each
against the plain version at `chip_smoke.PAGED_CASES` (q in float32 and
bfloat16, at `PAGED_TOL`), time each at the Qwen2.5-14B decode shape of
the path `ops_paged_decode` (q [8, 40, 128] over 3002 valid int8 pages of
[4104, 64, 8, 128]) beside the plain version and
`ops.paged_attention_serial` (CUDA events, two runs of 20 calls), sweep
the pages a block of the kept design, and read a clock64 profile of a
block's item loop by phase. Run on a machine with an NVIDIA GPU and nvcc:
`python3 benchmarks_torch/paged_variants.py`; one JSON object a line, the
card's name and power limit first.

A variant is a source and a list of (text, replacement) patches of it:

  final           the source as it is: a sequence's pages split over
                  blocks, `SPLIT_PAGES` a block, K and V rows staged by
                  cp.async in a ring of 2 items, the per-head loops
                  unrolled for the block's head count, a merge launch;
  whole_sequence  the first port's design
                  (`designs/refresh_paged_attention_whole_sequence.cu`):
                  a block a (sequence, kv head), its 8 warps taking the
                  pages in turn, loads straight into registers;
  stages3, stages4  rings of 3 and 4 items;
  heads8          every block computes PA_MAXG = 8 heads (q = 0 past its
                  group of 5) in place of an instantiation for its count;
  byte_perm       int8 to float32 by a byte permute into the mantissa of
                  2^23 and a subtraction in place of conversion
                  instructions;
  profile         `final` with clock64 probes: thread 0's cycles per item
                  in the wait for the item's copies, the scores, the
                  softmax and P.V.

Each variant is compiled by its own `nvcc` (all at once) into
`build/paged_variants/<name>/` and loaded with ctypes; the package's own
build is not touched. Its patches are text of the source: edit them with
the source."""
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
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import refresh_paged_attention as rpa

CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
DESIGNS = os.path.join(HERE, "benchmarks_torch", "designs")
SOURCE = os.path.join(CSRC, "refresh_paged_attention.cu")

PROF_NAMES = ("copy_wait", "scores", "softmax", "PV")


def _probe(k):
    return (f"    {{ const long long _n = clock64(); prof[{k}] += _n - plast; "
            f"plast = _n; }}\n")


PROFILE = [
    ("namespace {\n",
     "__device__ unsigned long long g_prof[8];\n"
     "extern \"C\" int read_prof(unsigned long long* h) {\n"
     "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}\n"
     "extern \"C\" int zero_prof() {\n"
     "  unsigned long long z[8] = {0};\n"
     "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n"
     "namespace {\n"),
    ("#pragma unroll 1\n  for (int k = 0; k < n_items; ++k) {\n",
     "  long long plast = clock64(), prof[4] = {0};\n"
     "#pragma unroll 1\n  for (int k = 0; k < n_items; ++k) {\n"),
    ("    __syncthreads();  // item k landed; item k - 1's stage is free\n",
     "    __syncthreads();  // item k landed; item k - 1's stage is free\n"
     + _probe(0)),
    ("        ps[j * PA_ROWS + sr] = sr < rows ? ksc * sc[j] : fk::NEG_INF;\n"
     "    }\n    __syncthreads();\n",
     "        ps[j * PA_ROWS + sr] = sr < rows ? ksc * sc[j] : fk::NEG_INF;\n"
     "    }\n    __syncthreads();\n" + _probe(1)),
    ("        if (lane == 0) salpha[j] = alpha;\n      }\n    }\n"
     "    __syncthreads();\n",
     "        if (lane == 0) salpha[j] = alpha;\n      }\n    }\n"
     "    __syncthreads();\n" + _probe(2)),
    ("\n  }\n\n  // the warps' sums",
     "\n" + _probe(3) + "  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    for (int k = 0; k < 4; ++k) atomicAdd(&g_prof[k], "
     "(unsigned long long)prof[k]);\n"
     "    atomicAdd(&g_prof[7], (unsigned long long)n_items);\n  }\n"
     "\n  // the warps' sums"),
]
BYTE_PERM = [("""  f[0] = (float)((int)(w << 24) >> 24);
  f[1] = (float)((int)(w << 16) >> 24);
  f[2] = (float)((int)(w << 8) >> 24);
  f[3] = (float)((int)w >> 24);""", """  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;""")]


def stages(n):
    return [("constexpr int PA_STAGES = 2;", f"constexpr int PA_STAGES = {n};")]


VARIANTS = {"final": (SOURCE, []),
            "whole_sequence": (os.path.join(
                DESIGNS, "refresh_paged_attention_whole_sequence.cu"), []),
            "stages3": (SOURCE, stages(3)), "stages4": (SOURCE, stages(4)),
            "heads8": (SOURCE, [("switch (min(H / Hkv, PA_MAXG)) {",
                                 "switch (PA_MAXG) {")]),
            "byte_perm": (SOURCE, BYTE_PERM), "profile": (SOURCE, PROFILE)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(name, source, patches):
    """Start nvcc on the patched source; returns (library path, process)."""
    src = open(source).read()
    for a, b in patches:
        if src.count(a) != 1:
            raise RuntimeError(f"variant {name}: patch text found "
                               f"{src.count(a)} times: {a[:60]!r}")
        src = src.replace(a, b)
    out = os.path.join(HERE, "build", "paged_variants", name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "refresh_paged_attention.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out, "lib.so")
    return so, subprocess.Popen(
        [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared",
         "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def launcher(lib, whole):
    """run(q, k8, v8, ks, vs, table, lens, page_size, split) through a
    variant's library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "bf16"):
        fn = getattr(lib, f"paged_attention_{dt}_launch")
        fn.argtypes = ([p] * 8 + [i] * 6 + [p]) if whole else (
            [p] * 9 + [i] * 7 + [p])
        fn.restype = i

    def run(q, k8, v8, ks, vs, table, lens, page_size,
            split=rpa.SPLIT_PAGES):
        b, h, d = q.shape
        hkv, maxp = k8.shape[2], table.shape[1]
        out = torch.empty_like(q)
        fn = getattr(lib, "paged_attention_"
                     + ("f32" if q.dtype == torch.float32 else "bf16")
                     + "_launch")
        ptrs = [t.data_ptr() for t in (q, k8, v8, ks, vs, table, lens, out)]
        stream = torch.cuda.current_stream().cuda_stream
        if whole:
            err = fn(*ptrs, b, h, hkv, d, page_size, maxp, stream)
        else:
            nsplit = max(1, -(-maxp // split))
            ws = torch.empty(b * h * nsplit * (d + 2), device="cuda")
            err = fn(*ptrs, ws.data_ptr(), b, h, hkv, d, page_size, maxp,
                     split, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def worst_ratio(run):
    """Largest |got - want| / (atol + rtol |want|) over PAGED_CASES, by
    q's dtype: below 1 is within the bar."""
    worst = {}
    for (b, h, hkv, d, t, maxp, lens) in cs.PAGED_CASES:
        q, *cache = cs.paged_case(torch, np, b, h, hkv, d, t, maxp, lens,
                                  seed=b * 10 + h)
        for dtype in (torch.float32, torch.bfloat16):
            qd = q.to(dtype)
            got = run(qd, *cache, t).float()
            want = rpa.paged_attention_torch(qd, *cache,
                                             page_size=t).float()
            atol, rtol = cs.PAGED_TOL[cs.dtype_name(dtype)]
            name = cs.dtype_name(dtype)
            worst[name] = max(worst.get(name, 0.0), float(
                ((got - want).abs() / (atol + rtol * want.abs())).max()))
    return worst


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    procs = {name: build(name, src, patches)
             for name, (src, patches) in VARIANTS.items()}
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        emit({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]})
        libs[name] = ctypes.CDLL(so)
    runs = {name: launcher(lib, name == "whole_sequence")
            for name, lib in libs.items()}
    for name, run in runs.items():
        emit({"variant": name, "worst_ratio_to_bar": worst_ratio(run)})
    (kp, q, cache, valid_pages), _ = cs.paged_decode_path(torch, np)
    del kp
    t = cs.PAGE
    for dt in (torch.float32, torch.bfloat16):
        qd = q.to(dt)
        row = {"dtype": cs.dtype_name(dt), "q": list(q.shape),
               "valid_pages": valid_pages,
               "plain_ms": [cs.time_cuda(torch, lambda i: (
                   rpa.paged_attention_torch(qd, *cache, page_size=t)), 5)
                   for _ in range(2)],
               "serial_ms": [cs.time_cuda(torch, lambda i: (
                   ops.paged_attention_serial(qd, *cache, page_size=t)), 5)
                   for _ in range(2)]}
        for name, run in runs.items():
            row[f"{name}_ms"] = [cs.time_cuda(
                torch, lambda i: run(qd, *cache, t), 20) for _ in range(2)]
        emit(row)
    emit({"split_pages_ms": {
        sp: cs.time_cuda(torch, lambda i: runs["final"](q, *cache, t, sp), 20)
        for sp in (2, 4, 8, 16, 32, 64)}})
    lib = libs["profile"]
    lib.zero_prof.argtypes, lib.zero_prof.restype = [], ctypes.c_int
    lib.read_prof.argtypes = [ctypes.c_void_p]
    lib.read_prof.restype = ctypes.c_int
    lib.zero_prof()
    runs["profile"](q, *cache, t)
    torch.cuda.synchronize()
    h = np.zeros(8, np.uint64)
    lib.read_prof(h.ctypes.data_as(ctypes.c_void_p))
    items = max(int(h[7]), 1)
    emit({"profile_items": items, "cycles_per_item": {
        n: round(float(v) / items, 1) for n, v in zip(PROF_NAMES, h[:4])}})


if __name__ == "__main__":
    main()
