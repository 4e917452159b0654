"""Kernel D's design choices, measured: build `csrc/kv_quant.cu`, variants
of it and the first port's design side by side, hold each against the
plain version (`ref.kv_quant`) at `chip_smoke.KV_QUANT_SHAPES` in float32
and bfloat16, on finite pages and on pages with a NaN slice and an inf
slice, and time each at the Qwen2.5-14B decode pages of the path
`ops_paged_decode`, [4104, 64, 8, 128], in float32 and in bfloat16
(CUDA events, two runs of 20 calls) beside the plain version, the bytes
bound and a device-to-device `copy_` of the same pages - the card's
practical bandwidth, read for context only (no PyTorch call computes D,
so `library_ms` stays None). Run on a machine with an NVIDIA GPU and
nvcc: `python3 benchmarks_torch/quant_variants.py`; one JSON object a
line, the card's name and power limit first.

A variant is a source and a list of (text, replacement) patches of it:

  final       the source as it is: a block a (page, head) slice, the
              slice in registers, 8 vectors of 16 bytes a thread (256
              threads in f32, 128 in bf16), one pass, streaming hints
              (loads `ld.global.nc.L1::no_allocate`, stores `__stcs`);
  ldcs        the same with `__ldcs` loads;
  no_hints    the same with plain loads and stores;
  threads64   blocks of 64 threads, 16 vectors a thread (f32: two tiles,
              the slice read twice);
  threads128  blocks of 128 threads (f32: 16 vectors a thread);
  threads256  blocks of 256 threads (bf16: 4 vectors a thread);
  threads512  blocks of 512 threads, 4 vectors a thread in f32, 2 in bf16;
  two_pass    the first port's design (`designs/kv_quant_two_pass.cu`):
              a block of 256 threads a slice, an absmax walk and a
              quantize walk, scalar loads, byte stores. It gives a finite
              scale for a NaN slice, so it fails the non-finite check and
              is timed all the same;
  tie_check   `x * (1 / scale)`, rounded, and the true division only
              where that product lies within 2^-13 of a half-integer (it
              is within 2^-22 of x / scale, relatively, and |x / scale|
              <= 127, so elsewhere both round to the same integer);
  reciprocal  a probe, not a design: `x * (1 / scale)` in place of the
              true division, one rounding off it (it fails the checks and
              is timed all the same), to read what the division costs.

A variant that fails the finite check is not timed, probes aside. The
variants are timed in two rounds, the second in the reverse order, so
that no variant always runs first.

Each variant is compiled by its own `nvcc` (all at once) into
`build/quant_variants/<name>/` and loaded with ctypes; the package's own
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

import torch

import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels import kv_quant as kq

CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
DESIGNS = os.path.join(HERE, "benchmarks_torch", "designs")
SOURCE = os.path.join(CSRC, "kv_quant.cu")
PAGES = (cs.DECODE_PAGES, cs.PAGE, cs.QWEN_HKV, cs.QWEN_D)

LDCS = [("#define KQ_LD ld_stream", "#define KQ_LD __ldcs")]
NO_HINTS = [("#define KQ_LD ld_stream\n#define KQ_ST __stcs",
             "#define KQ_LD(p) (*(p))\n#define KQ_ST(p, v) (*(p) = (v))")]
MAX_NV16 = [("    case 8: return by_nt<BF16, VB, 8>(a, nt);\n",
             "    case 8: return by_nt<BF16, VB, 8>(a, nt);\n"
             "    case 16: return by_nt<BF16, VB, 16>(a, nt);\n")]
TIE_CHECK = [("  const float v = __fdiv_rn(__uint_as_float(bits), s);",
              "  const float x = __uint_as_float(bits), y = x * __frcp_rn(s);\n"
              "  float v = rintf(y);\n"
              "  if (0.5f - fabsf(y - v) < 0x1p-13f) v = __fdiv_rn(x, s);")]
RECIPROCAL = [("  const float v = __fdiv_rn(__uint_as_float(bits), s);",
               "  const float v = __uint_as_float(bits) * __frcp_rn(s);")]


def block_of(n):
    """An instantiation for blocks of `n` threads."""
    line = "    case 256: return go<BF16, VB, NV, 256>(a);\n"
    return [(line, line + line.replace("256", str(n)))]


def planner(threads=None, max_vectors=8):
    return lambda t, d, itemsize: kq.plan(t, d, itemsize, threads,
                                          max_vectors)


# name: (source, patches, plan(t, d, itemsize) or None for the first
# port's entry points)
VARIANTS = {
    "final": (SOURCE, [], kq.plan),
    "ldcs": (SOURCE, LDCS, kq.plan),
    "no_hints": (SOURCE, NO_HINTS, kq.plan),
    "threads64": (SOURCE, block_of(64) + MAX_NV16, planner(64, 16)),
    "threads128": (SOURCE, MAX_NV16, planner(128, 16)),
    "threads256": (SOURCE, [], planner(256)),
    "threads512": (SOURCE, block_of(512), planner(512)),
    "two_pass": (os.path.join(DESIGNS, "kv_quant_two_pass.cu"), [], None),
    "tie_check": (SOURCE, TIE_CHECK, kq.plan),
    "reciprocal": (SOURCE, RECIPROCAL, kq.plan)}
PROBES = ("reciprocal",)


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
    out = os.path.join(HERE, "build", "quant_variants", name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "kv_quant.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out, "lib.so")
    return so, subprocess.Popen(
        [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared",
         "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def launcher(lib, plan):
    """run(pages) -> (int8 pages, scales) through a variant's library;
    `plan` None is the first port's entry point (no vector size, no
    register tile, no block size)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fn = getattr(lib, f"kv_quant_{name}_launch")
        fn.argtypes = [p] * 3 + [i] * (4 if plan is None else 7) + [p]
        fn.restype = i
        fns[dt] = fn

    def run(pages):
        pn, t, h, d = pages.shape
        q = torch.empty(pages.shape, dtype=torch.int8, device="cuda")
        sc = torch.empty((pn, h), dtype=torch.float32, device="cuda")
        args = [pages.data_ptr(), q.data_ptr(), sc.data_ptr(), pn, t, h, d]
        if plan is not None:
            args += plan(t, d, pages.element_size())
        err = fns[pages.dtype](*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return q, sc
    return run


def checks(run):
    """{"finite": ok, "nonfinite": ok} over KV_QUANT_SHAPES in both
    dtypes, by `chip_smoke.check_kv_quant` (exact)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    ok = {}
    for nonfinite in (False, True):
        key = "nonfinite" if nonfinite else "finite"
        ok[key] = True
        for dtype in (torch.float32, torch.bfloat16):
            for shape in cs.KV_QUANT_SHAPES:
                x = cs.kv_quant_input(torch, g, shape, dtype, nonfinite)
                try:
                    cs.check_kv_quant(torch, x, *run(x), f"{shape}")
                except AssertionError as e:
                    ok[key] = False
                    ok[f"{key}_first_failure"] = f"{dtype} {e}"
                    break
            if not ok[key]:
                break
    return ok


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    procs = {name: build(name, src, patches)
             for name, (src, patches, _) in VARIANTS.items()}
    runs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            if name == "final":
                raise RuntimeError(f"the kept source does not build:\n{log}")
            emit({"variant": name, "build_failed": log[-2000:]})
            continue
        emit({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln][:4]})
        runs[name] = launcher(ctypes.CDLL(so), VARIANTS[name][2])
    for name in list(runs):
        ok = checks(runs[name])
        emit({"variant": name, "checks": ok})
        if not ok["finite"] and name not in PROBES:
            del runs[name]                    # not timed: it is wrong
    g = torch.Generator(device="cuda").manual_seed(0)
    f32 = torch.randn(PAGES, generator=g, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        x = f32 if dt == torch.float32 else f32.to(dt)
        nbytes = x.numel() * (x.element_size() + 1) + 4 * PAGES[0] * PAGES[2]
        dst = torch.empty_like(x)
        copy_ms = [cs.time_cuda(torch, lambda i: dst.copy_(x), 20)
                   for _ in range(2)]
        del dst
        row = {"dtype": cs.dtype_name(dt), "pages": list(PAGES),
               "bytes": nbytes, "bound_ms": cs.bound(nbytes, 0, 1.0)[0],
               "copy_ms": copy_ms,
               "copy_GBps": 2 * x.numel() * x.element_size()
               / min(copy_ms) / 1e6,
               "plain_ms": [cs.time_cuda(torch, lambda i: kq.kv_quant_torch(
                   x), 5) for _ in range(2)]}
        order = list(runs)
        for name in order + order[::-1]:
            row.setdefault(f"{name}_ms", []).append(
                cs.time_cuda(torch, lambda i: runs[name](x), 20))
        for name in order:
            row[f"{name}_GBps"] = nbytes / min(row[f"{name}_ms"]) / 1e6
        emit(row)
        del x
    emit({"plan": {name: {"f32": plan(cs.PAGE, cs.QWEN_D, 4),
                          "bf16": plan(cs.PAGE, cs.QWEN_D, 2)}
                   for name, (_, _, plan) in VARIANTS.items() if plan}})


if __name__ == "__main__":
    main()
