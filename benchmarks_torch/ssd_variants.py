"""Kernel F's design choices, measured: build `csrc/mamba2_ssd.cu`, variants
of it and the first port's design side by side, hold each against the
plain version at `chip_smoke.SSD_CASES` (at `SSD_TOL`), time each at the
mamba2-130m shape of the path `ops_ssd` (x [8, 4096, 24, 64], N 128, chunk
128) beside the plain version (CUDA events, two runs of 5 calls), sweep
the heads a block of the kept design, and read a clock64 profile of a
block's head loop by phase. Run on a machine with an NVIDIA GPU and nvcc:
`python3 benchmarks_torch/ssd_variants.py`; one JSON object a line, the
card's name and power limit first.

A variant is a source and a list of (text, replacement) patches of it:

  final       the source as it is: a block a (batch, chunk, head group),
              3xTF32 on mma.sync, the state carried by a decoupled
              look-back;
  three_launches  the same products in three launches and no look-back:
              the kernel writes each chunk's own state and y without the
              carried term, a scan over the chunks turns the states into
              h_{c-1} in a workspace [B, nc, H, P, N] (201 MB at
              mamba2-130m), and a third kernel adds the carried term;
  cb_in_registers  an earlier state of this design
              (`designs/mamba2_ssd_cb_in_registers.cu`): C.B^T held in
              registers (64 a thread, 250 registers in all), x copied for
              the next head while one is computed (a second x buffer in
              place of C.B^T's shared memory), and C.h^T with C as the A
              operand;
  chunk_walk  the first port's design (`designs/mamba2_ssd_chunk_walk.cu`):
              a block a (batch, head) walks its chunks in order, every
              product a scalar float32 FMA over shared memory;
  profile     `final` with clock64 probes: thread 0's cycles per block in
              the set-up (copies and C.B^T), and per head in the cum
              scan, the decays with the wait for x, the S_c
              product (warp 0's issue), the wait for h_{c-1} (with the
              other warps' S_c), the look-back's loads, stores and fence,
              W.dtx (its issue), staging y (with W.dtx's last products),
              h.C^T and the y store.

Each variant is compiled by its own `nvcc` (all at once) into
`build/ssd_variants/<name>/` and loaded with ctypes; the package's own
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
from repro_torch.kernels import mamba2_ssd as ssd

CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
DESIGNS = os.path.join(HERE, "benchmarks_torch", "designs")
SOURCE = os.path.join(CSRC, "mamba2_ssd.cu")

PROF_NAMES = ("setup", "scan", "decays_and_x_wait", "S_warp0", "h_wait",
              "lookback_io", "W_dtx", "stage_y", "h_CT", "y_store")


def _probe(k):
    return (f"    {{ const long long _n = clock64(); prof[{k}] += _n - plast; "
            f"plast = _n; }}\n")


PROFILE = [
    ("namespace {\n",
     "__device__ unsigned long long g_prof[16];\n"
     "extern \"C\" int read_prof(unsigned long long* h) {\n"
     "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}\n"
     "extern \"C\" int zero_prof() {\n"
     "  unsigned long long z[16] = {0};\n"
     "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n"
     "namespace {\n"),
    ("  if (tid == 0) s_ticket = atomicAdd(flags, 1);\n",
     "  long long plast = clock64(), prof[10] = {0};\n"
     "  if (tid == 0) s_ticket = atomicAdd(flags, 1);\n"),
    ("  const bool first = c == 0, last = c == nc - 1;\n",
     "  const bool first = c == 0, last = c == nc - 1;\n" + _probe(0)),
    ("    __syncthreads();\n    const float total = cum[L - 1];\n",
     "    __syncthreads();\n" + _probe(1)
     + "    const float total = cum[L - 1];\n"),
    ("    __syncthreads();  // x of head h and the decays are in shared memory\n",
     "    __syncthreads();  // x of head h and the decays are in shared memory\n"
     + _probe(2)),
    ("    // the carried state: wait for h_{c-1}, publish h_c\n",
     _probe(3) + "    // the carried state: wait for h_{c-1}, publish h_c\n"),
    ("        while (ld_acquire(flag) < c) __nanosleep(64);\n"
     "      __syncthreads();\n",
     "        while (ld_acquire(flag) < c) __nanosleep(64);\n"
     "      __syncthreads();\n" + _probe(4)),
    ("      st_release(flag, c + 1);\n    }\n",
     "      st_release(flag, c + 1);\n    }\n" + _probe(5)),
    ("    __syncthreads();  // x is read: X stages y from here on\n",
     "    __syncthreads();  // x is read: X stages y from here on\n"
     + _probe(6)),
    ("    __syncthreads();\n\n    // y^T += ",
     "    __syncthreads();\n" + _probe(7) + "\n    // y^T += "),
    ("    __syncthreads();\n    for (int i = tid; i < L * p4; i += SSD_THREADS) {\n"
     "      const int l = i / p4, pp = (i - l * p4) * 4;\n"
     "      *reinterpret_cast<float4*>(y +",
     "    __syncthreads();\n" + _probe(8)
     + "    for (int i = tid; i < L * p4; i += SSD_THREADS) {\n"
     "      const int l = i / p4, pp = (i - l * p4) * 4;\n"
     "      *reinterpret_cast<float4*>(y +"),
    ("    __syncthreads();  // y is read out of X before the next head's copies\n"
     "  }\n}\n",
     "    __syncthreads();  // y is read out of X before the next head's copies\n"
     + _probe(9) + "  }\n"
     "  if (tid == 0) {\n"
     "    for (int k = 0; k < 10; ++k) atomicAdd(&g_prof[k], "
     "(unsigned long long)prof[k]);\n"
     "    atomicAdd(&g_prof[14], 1ull);\n"
     "    atomicAdd(&g_prof[15], (unsigned long long)hn);\n  }\n}\n"),
]
# three launches: the kept kernel without the look-back writes each
# chunk's own state S_c and its total to a workspace [B, nc, H, P, N] and y
# without the carried term; a scan turns S_c into h_{c-1} in place; a third
# kernel adds exp(cum_i) (h_{c-1}.C^T)^T to y
SCAN_AND_CARRY = r"""
__global__ void ssd_scan_kernel(float* ws, int Bsz, int nc, int H, int P,
                                int N) {
  // a thread an element of a (batch, head)'s state, walking the chunks
  const int per = (P * N + SSD_THREADS - 1) / SSD_THREADS;
  const int bh = blockIdx.x / per, b = bh / H, h = bh - b * H;
  const int i = (blockIdx.x - bh * per) * SSD_THREADS + threadIdx.x;
  if (i >= P * N) return;
  const size_t hs = (size_t)P * N;
  const float* tot = ws + (size_t)Bsz * nc * H * hs;
  float run = 0.f;
  for (int c = 0; c < nc; ++c) {
    float* q = ws + (((size_t)b * nc + c) * H + h) * hs + i;
    const float s = *q;
    *q = run;
    run = fmaf(run, expf(tot[((size_t)b * nc + c) * H + h]), s);
  }
}

__global__ void __launch_bounds__(SSD_THREADS, 1) ssd_carry_kernel(
    const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Cm, float* __restrict__ y,
    const float* __restrict__ ws, int Bsz, int S, int H, int P, int N,
    int L, int hpb) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;
  float* X = Cs + SSD_MAXL * CST;
  float* cum = X + SSD_MAXL * XST;
  float* ecum = cum + SSD_MAXL;
  float* dtb = ecum + SSD_MAXL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nc = S / L, ngrp = (H + hpb - 1) / hpb;
  const int blk = blockIdx.x, c = blk / (Bsz * ngrp);
  const int b = (blk - c * Bsz * ngrp) / ngrp;
  const int h0 = (blk - c * Bsz * ngrp - b * ngrp) * hpb;
  const int hn = min(hpb, H - h0);
  if (c == 0) return;
  const int total_floats = SSD_MAXL * (CST + XST + 2 + hpb);
  for (int i = tid * 4; i < total_floats; i += SSD_THREADS * 4)
    *reinterpret_cast<float4*>(smem + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const long long row0 = (long long)b * S + (long long)c * L;
  const int n4 = N / 4, p4 = P / 4;
  for (int i = tid; i < L * n4; i += SSD_THREADS) {
    const int l = i / n4, cc = (i - l * n4) * 4;
    fk::cp_async16(Cs + l * CST + cc, Cm + (row0 + l) * N + cc);
  }
  fk::cp_commit();
  for (int i = tid; i < L * hn; i += SSD_THREADS) {
    const int l = i / hn, k = i - l * hn;
    dtb[k * SSD_MAXL + l] = dt[(row0 + l) * H + h0 + k];
  }
  fk::cp_wait<0>();
  __syncthreads();
  const int mp = warp & 3, nh = warp >> 2;
  const bool p_on = 16 * mp < P;
  for (int hi = 0; hi < hn; ++hi) {
    const int h = h0 + hi;
    const float a = A[h];
    const float* dts = dtb + hi * SSD_MAXL;
    for (int i = tid; i < L * p4; i += SSD_THREADS) {
      const int l = i / p4, pp = (i - l * p4) * 4;
      fk::cp_async16(X + l * XST + pp, y + ((row0 + l) * H + h) * P + pp);
    }
    fk::cp_commit();
    if (warp == 0) {
      float v[4], run = 0.f;
      for (int e = 0; e < 4; ++e) {
        const int l = 4 * lane + e;
        run += l < L ? __fmul_rn(dts[l], a) : 0.f;
        v[e] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(fk::FULL_MASK, incl, off);
        if (lane >= off) incl += n;
      }
      float excl = __shfl_up_sync(fk::FULL_MASK, incl, 1);
      if (lane == 0) excl = 0.f;
      for (int e = 0; e < 4; ++e)
        if (4 * lane + e < L) ecum[4 * lane + e] = expf(excl + v[e]);
    }
    const float* hp = ws + (((size_t)b * nc + c) * H + h) * (size_t)P * N;
    float ha[16][4];
#pragma unroll
    for (int ks = 0; ks < 16; ++ks)
      ha[ks][0] = ha[ks][1] = ha[ks][2] = ha[ks][3] = 0.f;
    if (p_on) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * mp + g + 8 * r;
        if (p < P) {
#pragma unroll
          for (int ks = 0; ks < 16; ++ks) {
            const int n = 8 * ks + t;
            if (n < N) ha[ks][r] = hp[p * N + n];
            if (n + 4 < N) ha[ks][2 + r] = hp[p * N + n + 4];
          }
        }
      }
    }
    fk::cp_wait<0>();
    __syncthreads();
    if (p_on) {
      float yo[8][4];
#pragma unroll
      for (int it = 0; it < 8; ++it)
        yo[it][0] = yo[it][1] = yo[it][2] = yo[it][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 16; ++ks) {
        uint32_t ah[4], al[4];
        fk::split_a(ha[ks], ah, al);
#pragma unroll
        for (int it = 0; it < 8; ++it) {
          const float* cr = Cs + (8 * (8 * nh + it) + g) * CST + 8 * ks + t;
          fk::mma_3xtf32(yo[it], ah, al, cr[0], cr[4]);
        }
      }
#pragma unroll
      for (int it = 0; it < 8; ++it) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * mp + g + 8 * (e >> 1);
          const int i = 8 * (8 * nh + it) + 2 * t + (e & 1);
          if (i < L && p < P) X[i * XST + p] += ecum[i] * yo[it][e];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < L * p4; i += SSD_THREADS) {
      const int l = i / p4, pp = (i - l * p4) * 4;
      *reinterpret_cast<float4*>(y + ((row0 + l) * H + h) * P + pp) =
          *reinterpret_cast<const float4*>(X + l * XST + pp);
    }
    __syncthreads();
  }
}

}  // namespace
"""
THREE_LAUNCHES = [
    ("    if (!first) {\n      if (tid == 0)\n",
     "    if (false) {\n      if (tid == 0)\n"),
    ("    if ((!last || hlast) && p_on) {\n"
     "      float* hp = last ? hlast : ring + (slot0 + (c & 1)) * hstride;\n",
     "    if (tid == 0)\n"
     "      ring[(size_t)Bsz * nc * H * hstride + ((size_t)b * nc + c) * H + h]"
     " = total;\n"
     "    if (p_on) {\n"
     "      float* hp = ring + (((size_t)b * nc + c) * H + h) * hstride;\n"),
    ("    if (!last && tid == 0) {\n      __threadfence();",
     "    if (false) {\n      __threadfence();"),
    ("    if (!first && p_on) {\n      float yo[8][4];",
     "    if (false) {\n      float yo[8][4];"),
    ("\n}  // namespace\n", "\n" + SCAN_AND_CARRY),
    ("      Bsz, S, H, G, P, N, L, hpb);\n  return (int)cudaGetLastError();\n}",
     "      Bsz, S, H, G, P, N, L, hpb);\n"
     "  err = cudaGetLastError();\n  if (err != cudaSuccess) return (int)err;\n"
     "  ssd_scan_kernel<<<Bsz * H * ((P * N + SSD_THREADS - 1) / SSD_THREADS),\n"
     "                    SSD_THREADS, 0, (cudaStream_t)stream>>>(\n"
     "      (float*)ring, Bsz, S / L, H, P, N);\n"
     "  err = cudaGetLastError();\n  if (err != cudaSuccess) return (int)err;\n"
     "  const int csmem = SSD_MAXL * (CST + XST + 2 + hpb) * (int)sizeof(float);\n"
     "  err = cudaFuncSetAttribute(ssd_carry_kernel,\n"
     "      cudaFuncAttributeMaxDynamicSharedMemorySize, csmem);\n"
     "  if (err != cudaSuccess) return (int)err;\n"
     "  ssd_carry_kernel<<<blocks, SSD_THREADS, csmem, (cudaStream_t)stream>>>(\n"
     "      (const float*)dt, (const float*)A, (const float*)Cm, (float*)y,\n"
     "      (const float*)ring, Bsz, S, H, P, N, L, hpb);\n"
     "  return (int)cudaGetLastError();\n}"),
]
VARIANTS = {"final": (SOURCE, []),
            "three_launches": (SOURCE, THREE_LAUNCHES),
            "cb_in_registers": (
                os.path.join(DESIGNS, "mamba2_ssd_cb_in_registers.cu"), []),
            "chunk_walk": (os.path.join(DESIGNS, "mamba2_ssd_chunk_walk.cu"),
                           []),
            "profile": (SOURCE, PROFILE)}


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
    out = os.path.join(HERE, "build", "ssd_variants", name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "mamba2_ssd.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out, "lib.so")
    return so, subprocess.Popen(
        [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared",
         "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def launcher(lib, walk, full_workspace=False, state_arg=True):
    """run(x, dt, A, B, C, chunk, hpb) through a variant's library; the
    three-launch variant takes a workspace of every chunk's state. The
    kept source's launch function (`state_arg`) takes a final-state
    pointer after y, passed null here: y alone is compared and timed; and
    a B/C group count after H, passed 1 (one B and C for every head)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.mamba2_ssd_f32_launch
    fn.argtypes = ([p] * 6 + [i] * 6 + [p]) if walk else (
        [p] * (8 + state_arg) + [i] * (7 + state_arg) + [p])
    fn.restype = i

    def run(x, dt, A, B, C, chunk, hpb=ssd.HEADS_PER_BLOCK):
        b, s, h, pw = x.shape
        n = B.shape[-1]
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (x, dt, A, B, C, y)]
        if state_arg and not walk:
            ptrs.append(0)
        if walk:
            err = fn(*ptrs, b, s, h, pw, n, chunk, stream)
        else:
            nc = s // chunk
            ring = torch.empty(b * nc * h * (pw * n + 1) if full_workspace
                               else b * h * 2 * pw * n, device="cuda")
            flags = torch.zeros(1 + b * h, dtype=torch.int32, device="cuda")
            groups = (1,) if state_arg else ()
            err = fn(*ptrs, ring.data_ptr(), flags.data_ptr(), b, s, h,
                     *groups, pw, n, chunk, min(hpb, h), stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return y
    return run


def worst_ratio(run):
    """Largest |got - want| / (atol + rtol |want|) over SSD_CASES: below 1
    is within the bar."""
    g = torch.Generator(device="cuda").manual_seed(5)
    atol, rtol = cs.SSD_TOL
    worst = 0.0
    for (b, s, h, p, n, chunk) in cs.SSD_CASES:
        args = cs.ssd_inputs(torch, g, b, s, h, p, n)
        got = run(*args, min(chunk, s))
        want = ssd.mamba2_ssd_torch(*args, chunk=chunk)
        worst = max(worst, float(((got - want).abs()
                                  / (atol + rtol * want.abs())).max()))
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
    runs = {name: launcher(lib, name == "chunk_walk",
                           name == "three_launches",
                           VARIANTS[name][0] == SOURCE)
            for name, lib in libs.items()}
    for name, run in runs.items():
        emit({"variant": name, "worst_ratio_to_bar": worst_ratio(run)})
    g = torch.Generator(device="cuda").manual_seed(2)
    args = cs.ssd_inputs(torch, g, cs.SSD_B, cs.SSD_S, cs.SSD_H, cs.SSD_P,
                         cs.SSD_N)
    ch = cs.SSD_CHUNK
    row = {"x": list(args[0].shape), "chunk": ch,
           "plain_ms": [cs.time_cuda(torch, lambda i: ssd.mamba2_ssd_torch(
               *args, chunk=ch), 3) for _ in range(2)]}
    for name, run in runs.items():
        row[f"{name}_ms"] = [cs.time_cuda(torch, lambda i: run(*args, ch), 5)
                             for _ in range(2)]
    emit(row)
    emit({"heads_per_block_ms": {
        hpb: cs.time_cuda(torch, lambda i: runs["final"](*args, ch, hpb), 5)
        for hpb in (1, 2, 3, 4, 6, 8, 12, 24)}})
    lib = libs["profile"]
    lib.zero_prof.argtypes, lib.zero_prof.restype = [], ctypes.c_int
    lib.read_prof.argtypes = [ctypes.c_void_p]
    lib.read_prof.restype = ctypes.c_int
    lib.zero_prof()
    runs["profile"](*args, ch)
    torch.cuda.synchronize()
    h = np.zeros(16, np.uint64)
    lib.read_prof(h.ctypes.data_as(ctypes.c_void_p))
    blocks, heads = max(int(h[14]), 1), max(int(h[15]), 1)
    emit({"profile_blocks": blocks, "heads": heads,
          "setup_cycles_per_block": round(float(h[0]) / blocks, 1),
          "cycles_per_head": {n: round(float(v) / heads, 1)
                              for n, v in zip(PROF_NAMES[1:], h[1:10])}})


if __name__ == "__main__":
    main()
