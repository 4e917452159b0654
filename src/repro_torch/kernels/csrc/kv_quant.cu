// kv_quant_kernel - per-page, per-head int8 quantization of a KV cache
// page (kernel D).
//
// Replaces the TPU kernel `_kv_quant_kernel` of the JAX package
// (repro/kernels/kv_quant.py). Plain version: `ref.kv_quant` in
// repro_torch/kernels/ref.py; wrapper: repro_torch/kernels/kv_quant.py.
//
// pages [P, T, H, D] (float32 or bfloat16) -> int8 [P, T, H, D] and
// scale [P, H] float32: scale = max(absmax over (T, D), 1e-8) / 127,
// q = clip(rint(x / scale), -127, 127). `x / scale` is a true IEEE
// division and the conversion rounds half to even, as jnp.round does, so
// the kernel equals the oracle value for value. As jnp.max and
// jnp.maximum do, a NaN in a slice makes its scale NaN and an inf makes
// it inf; where x / scale is NaN (every value under a NaN scale, +-inf
// under an inf one) the kernel stores 0.
//
// Bound by bytes: each element is read once and written once as a byte,
// against a compare, a division and a rounding. One pass, the slice in
// registers: a block of NT threads takes one (page, head) slice, T rows
// of D values a row stride of H * D apart. Each thread loads its NV
// vectors of VB bytes (neighbouring threads on neighbouring vectors of a
// row), all issued before any is used, with streaming hints: every byte
// is touched once (loads `ld.global.nc.L1::no_allocate`, stores `__stcs`).
// The absmax is a max over the bit patterns of |x| as unsigned integers -
// a NaN's bits exceed +inf's, so `__reduce_max_sync` carries a NaN
// through - across the warps through shared memory. The
// values are then quantized from the registers and stored packed (4 int8
// in 32 bits from 16 bytes of f32, 8 in 64 bits from 16 bytes of bf16).
// Nothing is read twice, except in a slice larger than the register tile
// (NT * NV vectors), which is walked tile by tile: the absmax over every
// tile, then the quantization, which reloads (from L2) every tile but the
// last, still in registers.
//
// Instantiations: VB (16, 8, 4, or 2 for bf16) is the largest vector that
// divides a row's bytes, so every vector is aligned (the pages start on
// 16 bytes); NT (128 or 256) and NV (1, 2, 4 or 8) aim at 8 vectors of 16
// bytes a thread: 256 threads for a slice of more than
// 1024 vectors (f32 at D = 112, 128), else 128 (bf16 at every model
// width, f32 at D = 64), and the fewest vectors a thread that cover the
// slice. The wrapper picks them (`plan` in kv_quant.py); any pick gives
// the same values, the pick sets the speed. A thread's vectors lie NT
// apart in the slice: it walks them by (row, column) in fixed steps, from
// one division a tile, never one an element.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

// streaming loads (read-only path, no L1 line) and stores: each byte is
// read or written once
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_stream(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned int ld_stream(const unsigned int* p) {
  unsigned int v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned short ld_stream(const unsigned short* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}
#define KQ_LD ld_stream
#define KQ_ST __stcs

// the slice's geometry in vectors, and a thread's steps through it
struct Slice {
  int rows, dv;        // rows (T) and vectors a row
  int rstep, cstep;    // NT vectors on, in rows and columns
  long long row;       // elements from one row to the next (H * D)
  long long base;      // element (p, 0, h, 0)
};

// a thread's position: row, column (in vectors) and element offset
struct Walk {
  int r, c;
  long long off;
};

template <int EV>
__device__ __forceinline__ Walk walk_at(const Slice& s, int v) {
  const int r = v / s.dv, c = v - r * s.dv;
  return {r, c, s.base + r * s.row + (long long)c * EV};
}

template <int EV>
__device__ __forceinline__ void step(Walk& k, const Slice& s) {
  k.r += s.rstep;
  k.c += s.cstep;
  if (k.c >= s.dv) {
    k.c -= s.dv;
    k.r += 1;
  }
  k.off = s.base + k.r * s.row + (long long)k.c * EV;
}

template <int VB>
__device__ __forceinline__ void load_vec(uint32_t* w, const unsigned char* p) {
  if constexpr (VB == 16) {
    const uint4 v = KQ_LD(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = KQ_LD(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else if constexpr (VB == 4) {
    w[0] = KQ_LD(reinterpret_cast<const unsigned int*>(p));
  } else {
    w[0] = KQ_LD(reinterpret_cast<const unsigned short*>(p));
  }
}

// element e of a vector as float32 bits (bf16 widens exactly by a shift)
template <bool BF16>
__device__ __forceinline__ uint32_t elem_bits(const uint32_t* w, int e) {
  if constexpr (BF16)
    return (e & 1) ? (w[e >> 1] & 0xffff0000u) : (w[e >> 1] << 16);
  else
    return w[e];
}

__device__ __forceinline__ uint32_t quant(uint32_t bits, float s) {
  const float v = __fdiv_rn(__uint_as_float(bits), s);
  // NaN stores 0, not the clip's -127; a finite |v| is at most 127 but
  // for rounding, and the clip keeps it there
  const int q = v == v ? max(-127, min(127, __float2int_rn(v))) : 0;
  return (uint32_t)q & 0xffu;
}

template <int EV>
__device__ __forceinline__ void store_q(unsigned char* p, const uint32_t* q) {
  if constexpr (EV == 8) {
    uint2 v;
    v.x = q[0] | q[1] << 8 | q[2] << 16 | q[3] << 24;
    v.y = q[4] | q[5] << 8 | q[6] << 16 | q[7] << 24;
    KQ_ST(reinterpret_cast<uint2*>(p), v);
  } else if constexpr (EV == 4) {
    KQ_ST(reinterpret_cast<unsigned int*>(p),
          q[0] | q[1] << 8 | q[2] << 16 | q[3] << 24);
  } else if constexpr (EV == 2) {
    KQ_ST(reinterpret_cast<unsigned short*>(p),
          (unsigned short)(q[0] | q[1] << 8));
  } else {
    KQ_ST(p, (unsigned char)q[0]);
  }
}

template <int ES, int VB, int NV, int W>
__device__ __forceinline__ void load_tile(uint32_t (&w)[NV][W],
                                          const unsigned char* pages,
                                          const Slice& s, int v0) {
  constexpr int EV = VB / ES;
  Walk k = walk_at<EV>(s, v0);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (k.r < s.rows) {
      load_vec<VB>(w[j], pages + k.off * ES);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) w[j][i] = 0u;
    }
    step<EV>(k, s);
  }
}

template <bool BF16, int VB, int NV, int NT>
__global__ void __launch_bounds__(NT)
    kv_quant_kernel(const unsigned char* __restrict__ pages,
                    unsigned char* __restrict__ q, float* __restrict__ scale,
                    int H, int Tn, int D) {
  constexpr int ES = BF16 ? 2 : 4;         // bytes an element
  constexpr int EV = VB / ES;              // elements a vector
  constexpr int W = VB >= 4 ? VB / 4 : 1;  // 32-bit words a vector
  constexpr int TILE = NT * NV;            // vectors a tile
  const int dv = D / EV;
  const long long p = blockIdx.x / H;
  const int h = (int)(blockIdx.x - p * H);
  const int rstep = NT / dv;
  const Slice s{Tn, dv, rstep, NT - rstep * dv, (long long)H * D,
                (p * Tn * H + h) * D};
  const int tiles = (Tn * dv + TILE - 1) / TILE;

  uint32_t w[NV][W];
  uint32_t amax = 0u;
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    load_tile<ES, VB, NV, W>(w, pages, s, t * TILE + threadIdx.x);
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < EV; ++e)
        amax = max(amax, elem_bits<BF16>(w[j], e) & 0x7fffffffu);
  }
  amax = __reduce_max_sync(0xffffffffu, amax);
  __shared__ uint32_t warp_amax[NT / 32];
  if ((threadIdx.x & 31) == 0) warp_amax[threadIdx.x >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) amax = max(amax, warp_amax[i]);
  const float a = __uint_as_float(amax);
  // max(a, 1e-8) that keeps a NaN, as jnp.maximum does
  const float sc = __fdiv_rn(a < 1e-8f ? 1e-8f : a, 127.0f);
  if (threadIdx.x == 0) scale[blockIdx.x] = sc;

  // the last tile is in registers: quantize it first, then reload the rest
#pragma unroll 1
  for (int t = tiles - 1; t >= 0; --t) {
    const int v0 = t * TILE + threadIdx.x;
    if (t != tiles - 1) load_tile<ES, VB, NV, W>(w, pages, s, v0);
    Walk k = walk_at<EV>(s, v0);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (k.r < s.rows) {
        uint32_t qv[EV];
#pragma unroll
        for (int e = 0; e < EV; ++e)
          qv[e] = quant(elem_bits<BF16>(w[j], e), sc);
        store_q<EV>(q + k.off, qv);
      }
      step<EV>(k, s);
    }
  }
}

struct Args {
  const void* pages;
  void* q;
  void* scale;
  int P, Tn, H, D;
  cudaStream_t stream;
};

template <bool BF16, int VB, int NV, int NT>
int go(const Args& a) {
  kv_quant_kernel<BF16, VB, NV, NT>
      <<<(unsigned)((long long)a.P * a.H), NT, 0, a.stream>>>(
          (const unsigned char*)a.pages, (unsigned char*)a.q,
          (float*)a.scale, a.H, a.Tn, a.D);
  return (int)cudaGetLastError();
}

template <bool BF16, int VB, int NV>
int by_nt(const Args& a, int nt) {
  switch (nt) {
    case 128: return go<BF16, VB, NV, 128>(a);
    case 256: return go<BF16, VB, NV, 256>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool BF16, int VB>
int by_nv(const Args& a, int nv, int nt) {
  switch (nv) {
    case 1: return by_nt<BF16, VB, 1>(a, nt);
    case 2: return by_nt<BF16, VB, 2>(a, nt);
    case 4: return by_nt<BF16, VB, 4>(a, nt);
    case 8: return by_nt<BF16, VB, 8>(a, nt);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool BF16>
int launch(const Args& a, int vb, int nv, int nt) {
  if ((long long)a.P * a.H == 0 || a.Tn == 0 || a.D == 0) return 0;
  if (vb <= 0 || (a.D * (BF16 ? 2 : 4)) % vb)
    return (int)cudaErrorInvalidValue;
  switch (vb) {
    case 16: return by_nv<BF16, 16>(a, nv, nt);
    case 8: return by_nv<BF16, 8>(a, nv, nt);
    case 4: return by_nv<BF16, 4>(a, nv, nt);
    case 2:
      if constexpr (BF16) return by_nv<BF16, 2>(a, nv, nt);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// vb: bytes a vector (16, 8, 4; bf16 also 2), dividing D * element bytes;
// nv: vectors a thread (1, 2, 4, 8); nt: threads a block (128, 256).
// Anything else returns cudaErrorInvalidValue and launches nothing.
extern "C" int kv_quant_f32_launch(const void* pages, void* q, void* scale,
                                   int P, int Tn, int H, int D, int vb,
                                   int nv, int nt, void* stream) {
  return launch<false>({pages, q, scale, P, Tn, H, D, (cudaStream_t)stream},
                       vb, nv, nt);
}

extern "C" int kv_quant_bf16_launch(const void* pages, void* q,
                                    void* scale, int P, int Tn, int H,
                                    int D, int vb, int nv, int nt,
                                    void* stream) {
  return launch<true>({pages, q, scale, P, Tn, H, D, (cudaStream_t)stream},
                      vb, nv, nt);
}
