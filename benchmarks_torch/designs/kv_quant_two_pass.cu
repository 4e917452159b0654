// The first port's design of kernel D, kept for comparison by
// benchmarks_torch/quant_variants.py (variant `two_pass`); the package
// builds src/repro_torch/kernels/csrc/kv_quant.cu instead. Its C entry
// points take no vector size and no register tile. It takes a finite
// scale for a slice that holds a NaN (`fmaxf` drops NaN) and stores
// -127 for a NaN quotient, where the reference gives a NaN scale.
//
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
// division and rintf rounds half to even, as jnp.round does, so the
// kernel equals the oracle value for value.
//
// Bound by bytes: each element is read and written once against a
// handful of operations. One block of KQ_THREADS threads per (page,
// head): the threads walk the head's T rows of D contiguous values
// (neighbouring threads on neighbouring addresses), reduce the absmax
// through the warps and shared memory, then quantize on a second walk
// that finds the 32 KB slice (f32, T=64, D=128) in L1/L2.
#include <stdint.h>

#include "float_common.cuh"

namespace {

constexpr int KQ_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(KQ_THREADS)
    kv_quant_kernel(const T* __restrict__ pages, int8_t* __restrict__ q,
                    float* __restrict__ scale, int H, int Tn, int D) {
  const long long blk = blockIdx.x;  // (page, head), head fastest
  const long long p = blk / H;
  const int h = (int)(blk - p * H);
  const long long row_stride = (long long)H * D;
  const long long base = p * Tn * row_stride + (long long)h * D;
  const int n = Tn * D;

  float amax = 0.f;
  for (int i = threadIdx.x; i < n; i += KQ_THREADS) {
    const int t = i / D, d = i - t * D;
    amax = fmaxf(amax, fabsf(fk::to_f32(pages[base + t * row_stride + d])));
  }
  amax = fk::warp_max(amax);
  __shared__ float warp_amax[KQ_THREADS / 32];
  __shared__ float s_scale;
  if ((threadIdx.x & 31) == 0) warp_amax[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_amax[0];
    for (int w = 1; w < KQ_THREADS / 32; ++w) m = fmaxf(m, warp_amax[w]);
    const float s = fmaxf(m, 1e-8f) / 127.0f;
    s_scale = s;
    scale[blk] = s;
  }
  __syncthreads();
  const float s = s_scale;
  for (int i = threadIdx.x; i < n; i += KQ_THREADS) {
    const int t = i / D, d = i - t * D;
    const long long off = base + t * row_stride + d;
    const float v = rintf(fk::to_f32(pages[off]) / s);
    q[off] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
}

template <typename T>
int launch(const void* pages, void* q, void* scale, int P, int Tn, int H,
           int D, void* stream) {
  const long long blocks = (long long)P * H;
  if (blocks == 0) return 0;
  kv_quant_kernel<T><<<(unsigned)blocks, KQ_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const T*)pages, (int8_t*)q, (float*)scale, H, Tn, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kv_quant_f32_launch(const void* pages, void* q, void* scale,
                                   int P, int Tn, int H, int D,
                                   void* stream) {
  return launch<float>(pages, q, scale, P, Tn, H, D, stream);
}

extern "C" int kv_quant_bf16_launch(const void* pages, void* q,
                                    void* scale, int P, int Tn, int H,
                                    int D, void* stream) {
  return launch<__nv_bfloat16>(pages, q, scale, P, Tn, H, D, stream);
}
