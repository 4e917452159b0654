// mamba2_ssd_kernel - Mamba2 SSD (state-space duality) chunked forward
// (kernel F).
//
// Replaces the TPU kernel `_ssd_kernel` of the JAX package
// (repro/kernels/mamba2_ssd.py). Plain version: `ref.mamba2_ssd` in
// repro_torch/kernels/ref.py; wrapper: repro_torch/kernels/mamba2_ssd.py.
//
// x [B, S, H, P], dt [B, S, H], A [H], B/C [B, S, N], all float32 ->
// y [B, S, H, P]. Per (batch, head), over its chunks of L in order, with
// cum the within-chunk cumulative sum of dt * A[h] and total = cum[L-1]:
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dtx_j
//           + exp(cum_i) (C_i . h_p)                     (dtx = dt * x)
//   h    <- h exp(total) + sum_l exp(total - cum_l) dtx_l (x) B_l
//
// Bound by operations. Blocks run in no order, so the TPU grid's
// sequential chunk axis is a loop inside the block: one block of
// SSD_THREADS threads owns one (batch, head) and walks its chunks, with
// the chunk's B, C and dt * x and the state h [P, N] in shared memory
// (dynamic: 2 L (N+4) + L (P+4) + P (N+4) + 32 (L+4) + 4 L floats,
// 222,720 bytes at L = 128, N = 128, P = 64, set with
// cudaFuncSetAttribute). The L x L weights are built SSD_TILE rows at a
// time (only the columns j < i0 + SSD_TILE of a tile can be non-zero),
// and the decay exp(cum_i - cum_j) is evaluated only where j <= i: above
// the diagonal cum_i - cum_j > 0 can overflow and inf * 0 is NaN. Thread
// (ty = tid / 16, tx = tid % 16) owns rows i0 + 2ty, +1 of a tile: the
// weights of columns tx + 16k and the outputs of columns tx + 16e of y;
// in the state update it owns h[4ty .. +3][4tx + 64f .. +3].
#include "float_common.cuh"

namespace {

constexpr int SSD_THREADS = 256;
constexpr int SSD_TILE = 32;

int smem_floats(int L, int P, int N) {
  return 2 * L * (N + 4) + L * (P + 4) + P * (N + 4) + SSD_TILE * (L + 4) +
         4 * L;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__global__ void __launch_bounds__(SSD_THREADS) mamba2_ssd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y, int S, int H,
    int P, int N, int L) {
  extern __shared__ float4 smem4[];
  const int NS = N + 4, PS = P + 4, WS = L + 4;
  float* Bs = reinterpret_cast<float*>(smem4);  // [L][NS]
  float* Cs = Bs + L * NS;                      // [L][NS]
  float* Xs = Cs + L * NS;                      // [L][PS]   dt * x
  float* Hs = Xs + L * PS;                      // [P][NS]   the state
  float* Ws = Hs + P * NS;                      // [SSD_TILE][WS]
  float* dts = Ws + SSD_TILE * WS;              // [L]
  float* cum = dts + L;                         // [L]
  float* ecum = cum + L;                        // [L] exp(cum)
  float* dend = ecum + L;                       // [L] exp(total - cum)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = A[h];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int n4 = N / 4, p4 = P / 4;

  for (int idx = tid; idx < P * NS; idx += SSD_THREADS) Hs[idx] = 0.f;

  for (int c = 0; c < S / L; ++c) {
    const long long row0 = (long long)b * S + (long long)c * L;
    for (int idx = tid; idx < L * n4; idx += SSD_THREADS) {
      const int l = idx / n4, cc = (idx - l * n4) * 4;
      const long long g = (row0 + l) * N + cc;
      fk::store4(Bs + l * NS + cc, fk::load4(Bm + g));
      fk::store4(Cs + l * NS + cc, fk::load4(Cm + g));
    }
    for (int l = tid; l < L; l += SSD_THREADS)
      dts[l] = dt[(row0 + l) * H + h];
    __syncthreads();
    if (tid == 0) {  // within-chunk cumulative sum of dt * a, in order
      float run = 0.f;
      for (int l = 0; l < L; ++l) {
        run += __fmul_rn(dts[l], a);
        cum[l] = run;
      }
    }
    for (int idx = tid; idx < L * p4; idx += SSD_THREADS) {
      const int l = idx / p4, pp = (idx - l * p4) * 4;
      float4 v = fk::load4(x + ((row0 + l) * H + h) * P + pp);
      const float d = dts[l];
      v.x *= d;
      v.y *= d;
      v.z *= d;
      v.w *= d;
      fk::store4(Xs + l * PS + pp, v);
    }
    __syncthreads();
    const float total = cum[L - 1];
    for (int l = tid; l < L; l += SSD_THREADS) {
      ecum[l] = expf(cum[l]);
      dend[l] = expf(total - cum[l]);
    }
    __syncthreads();

    for (int i0 = 0; i0 < L; i0 += SSD_TILE) {
      const int jmax = min(i0 + SSD_TILE, L);
      const int kcount = (jmax + 15) / 16;
      const int ia = i0 + 2 * ty, ib = ia + 1;
      // weights W[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i
      float w[2][8];
#pragma unroll
      for (int k = 0; k < 8; ++k) w[0][k] = w[1][k] = 0.f;
      if (ia < L) {
        for (int nn = 0; nn < n4; ++nn) {
          const float4 c0 =
              *reinterpret_cast<const float4*>(Cs + ia * NS + 4 * nn);
          const float4 c1 =
              ib < L ? *reinterpret_cast<const float4*>(Cs + ib * NS + 4 * nn)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int j = tx + 16 * k;
            if (k < kcount && j < jmax) {
              const float4 bv =
                  *reinterpret_cast<const float4*>(Bs + j * NS + 4 * nn);
              w[0][k] += dot4(c0, bv);
              w[1][k] += dot4(c1, bv);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = ia + r;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = tx + 16 * k;
          if (k < kcount && j < jmax) {
            float val = 0.f;
            if (i < L && j <= i) val = w[r][k] * expf(cum[i] - cum[j]);
            Ws[(2 * ty + r) * WS + j] = val;
          }
        }
      }
      __syncthreads();

      // y rows ia, ib at columns p = tx + 16e
      float y0[4] = {0.f, 0.f, 0.f, 0.f}, y1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < jmax; ++j) {
        const float wa = Ws[(2 * ty) * WS + j];
        const float wb = Ws[(2 * ty + 1) * WS + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = tx + 16 * e;
          if (p < P) {
            const float xv = Xs[j * PS + p];
            y0[e] += wa * xv;
            y1[e] += wb * xv;
          }
        }
      }
      float z0[4] = {0.f, 0.f, 0.f, 0.f}, z1[4] = {0.f, 0.f, 0.f, 0.f};
      if (ia < L) {
        for (int nn = 0; nn < n4; ++nn) {
          const float4 c0 =
              *reinterpret_cast<const float4*>(Cs + ia * NS + 4 * nn);
          const float4 c1 =
              ib < L ? *reinterpret_cast<const float4*>(Cs + ib * NS + 4 * nn)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = tx + 16 * e;
            if (p < P) {
              const float4 hv =
                  *reinterpret_cast<const float4*>(Hs + p * NS + 4 * nn);
              z0[e] += dot4(c0, hv);
              z1[e] += dot4(c1, hv);
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = tx + 16 * e;
        if (p >= P) continue;
        if (ia < L)
          y[((row0 + ia) * H + h) * P + p] = y0[e] + ecum[ia] * z0[e];
        if (ib < L)
          y[((row0 + ib) * H + h) * P + p] = y1[e] + ecum[ib] * z1[e];
      }
      __syncthreads();  // the weight tile is rewritten by the next tile
    }

    // h = h exp(total) + sum_l (dtx_l exp(total - cum_l)) (x) B_l
    const float etot = expf(total);
    const int pb = 4 * ty;
    if (pb < P) {
      float u[4][2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int g = 0; g < 4; ++g) u[e][f][g] = 0.f;
      for (int l = 0; l < L; ++l) {
        const float de = dend[l];
        const float4 xv = *reinterpret_cast<const float4*>(Xs + l * PS + pb);
        const float xs[4] = {xv.x * de, xv.y * de, xv.z * de, xv.w * de};
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int nb = 4 * tx + 64 * f;
          if (nb < N) {
            const float4 bv =
                *reinterpret_cast<const float4*>(Bs + l * NS + nb);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              u[e][f][0] += xs[e] * bv.x;
              u[e][f][1] += xs[e] * bv.y;
              u[e][f][2] += xs[e] * bv.z;
              u[e][f][3] += xs[e] * bv.w;
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int nb = 4 * tx + 64 * f;
          if (nb < N) {
            float* hp = Hs + (pb + e) * NS + nb;
            float4 hv = *reinterpret_cast<float4*>(hp);
            hv.x = hv.x * etot + u[e][f][0];
            hv.y = hv.y * etot + u[e][f][1];
            hv.z = hv.z * etot + u[e][f][2];
            hv.w = hv.w * etot + u[e][f][3];
            *reinterpret_cast<float4*>(hp) = hv;
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites B, C, dt * x
  }
}

}  // namespace

extern "C" int mamba2_ssd_f32_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, void* y, int Bsz, int S,
                                     int H, int P, int N, int L,
                                     void* stream) {
  if (Bsz == 0 || H == 0 || S == 0) return 0;
  if (L <= 0 || S % L != 0 || L > 128 || P > 64 || N > 128 || P % 4 != 0 ||
      N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_floats(L, P, N) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mamba2_ssd_kernel<<<Bsz * H, SSD_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (float*)y, S, H, P, N, L);
  return (int)cudaGetLastError();
}
