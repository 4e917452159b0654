// flash_attention_kernel - attention forward with an online softmax,
// causal or not (kernel E).
//
// Replaces the TPU kernel `_flash_kernel` of the JAX package
// (repro/kernels/flash_attention.py). Plain version: `ref.flash_attention`
// in repro_torch/kernels/ref.py; wrapper: repro_torch/kernels/flash_attention.py.
//
// q [BH, Sq, D], k/v [BH, Skv, D] (float32 or bfloat16, kv GQA-expanded)
// -> [BH, Sq, D] of q's dtype. Blocks of q_blk = min(128, Sq) query rows
// and kv_blk = min(128, Skv) keys, as the TPU kernel's; under causality a
// kv block is skipped when k_start > q_start + q_blk - 1 (exactly the TPU
// kernel's skip) and inside a computed block scores with kpos > qpos are
// -1e30. The softmax is taken in float32: q is widened and scaled by
// 1/sqrt(D), scores, m, l and the accumulator are float32, and the
// result is narrowed on the store; out = acc / max(l, 1e-30).
//
// Bound by operations (4·q_blk·kv_blk·D multiply-adds a computed block
// pair against a few hundred KB of traffic a head). This kernel runs
// on the CUDA cores in float32, so its ceiling is the float32 rate.
// Block shape: FA_THREADS = 256 threads (8 warps) per (head, q block of
// up to FA_BQ = 128 rows); the scaled q block sits in shared memory, and
// each kv block is walked in sub-tiles of FA_BK = 32 keys staged in
// shared memory. Thread (ty = 0..31, tx = 0..7) owns rows 4ty..4ty+3: in
// the score tile keys tx + 8k (k < 4), in the accumulator columns
// 4tx + 32k .. +3 (k < 4) - 64 float32 sums a thread, so the 128 x 128
// accumulator is spread over the whole block's registers. A row's 8
// owners are neighbouring lanes, so its max and sum reduce by three
// shuffles. Probabilities pass to the P·V product through shared memory,
// stored transposed so that a thread reads its 4 rows as one float4.
// Dynamic shared memory: ~118 KB, set with cudaFuncSetAttribute.
#include "float_common.cuh"

namespace {

constexpr int FA_THREADS = 256;
constexpr int FA_BQ = 128;  // query rows a block: the TPU kernel's block
constexpr int FA_BK = 32;   // keys a staged sub-tile
constexpr int FA_DMAX = 128;
constexpr int FA_STRIDE = FA_DMAX + 4;  // floats a staged row (padding
                                        // spreads rows over the banks)
constexpr int FA_PSTRIDE = FA_BQ + 4;
constexpr int FA_SMEM_FLOATS =
    FA_BQ * FA_STRIDE + 2 * FA_BK * FA_STRIDE + FA_BK * FA_PSTRIDE;

template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv, int D,
    int q_blk, int kv_blk, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [FA_BQ][FA_STRIDE]
  float* Ks = Qs + FA_BQ * FA_STRIDE;           // [FA_BK][FA_STRIDE]
  float* Vs = Ks + FA_BK * FA_STRIDE;           // [FA_BK][FA_STRIDE]
  float* Pt = Vs + FA_BK * FA_STRIDE;           // [FA_BK][FA_PSTRIDE]

  const int nq = Sq / q_blk;
  // heaviest q blocks first: under causality the last reads the most
  const int qi = nq - 1 - (int)blockIdx.x;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 7;
  const int ty = (tid >> 5) * 4 + (lane >> 3);
  const int q_start = qi * q_blk;
  const int d4 = D / 4;

  const T* qb = q + (bh * Sq + q_start) * D;
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;

  // the q block, scaled, zero past its rows and past D
  for (int idx = tid; idx < FA_BQ * (FA_DMAX / 4); idx += FA_THREADS) {
    const int r = idx / (FA_DMAX / 4), c = (idx % (FA_DMAX / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < q_blk && c < D) {
      x = fk::load4(qb + (long long)r * D + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * FA_STRIDE + c) = x;
  }

  float acc[4][4][4];  // [row i][column group kc][4 columns]
  float m[4], l[4];    // l: this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = fk::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][kc][e] = 0.f;
  }

  const int n_kv = Skv / kv_blk;
  for (int ki = 0; ki < n_kv; ++ki) {
    const int k_start = ki * kv_blk;
    // the TPU kernel's skip; later blocks start later still
    if (causal && k_start > q_start + q_blk - 1) break;
    for (int sub = 0; sub < kv_blk; sub += FA_BK) {
      const int key0 = k_start + sub;
      const int nkeys = min(FA_BK, kv_blk - sub);
      __syncthreads();  // the previous sub-tile's K, V and P are consumed
      for (int idx = tid; idx < FA_BK * (FA_DMAX / 4); idx += FA_THREADS) {
        const int r = idx / (FA_DMAX / 4), c = (idx % (FA_DMAX / 4)) * 4;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (r < nkeys && c < D) {
          kx = fk::load4(kb + (long long)(key0 + r) * D + c);
          vx = fk::load4(vb + (long long)(key0 + r) * D + c);
        }
        *reinterpret_cast<float4*>(Ks + r * FA_STRIDE + c) = kx;
        *reinterpret_cast<float4*>(Vs + r * FA_STRIDE + c) = vx;
      }
      __syncthreads();

      // scores s[i][kk] = q[4ty + i] . k[tx + 8kk]
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) s[i][kk] = 0.f;
      for (int c = 0; c < d4; ++c) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              Qs + (4 * ty + i) * FA_STRIDE + 4 * c);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          kv[kk] = *reinterpret_cast<const float4*>(
              Ks + (tx + 8 * kk) * FA_STRIDE + 4 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            s[i][kk] += qv[i].x * kv[kk].x + qv[i].y * kv[kk].y +
                        qv[i].z * kv[kk].z + qv[i].w * kv[kk].w;
      }

      // online softmax over this sub-tile; absent keys (past the block)
      // take no part, masked ones score -1e30 as in the TPU kernel (key 0
      // of a sub-tile is always present, so every row has a maximum)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q_start + 4 * ty + i;
        float mx = fk::NEG_INF;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = tx + 8 * kk;
          if (j < nkeys) {
            if (causal && key0 + j > qpos) s[i][kk] = fk::NEG_INF;
            mx = fmaxf(mx, s[i][kk]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(fk::FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(fk::FULL_MASK, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(fk::FULL_MASK, mx, 4));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = tx + 8 * kk;
          s[i][kk] = j < nkeys ? expf(s[i][kk] - m_new) : 0.f;
          psum += s[i][kk];
        }
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][kc][e] *= alpha;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        *reinterpret_cast<float4*>(Pt + (tx + 8 * kk) * FA_PSTRIDE +
                                   4 * ty) =
            make_float4(s[0][kk], s[1][kk], s[2][kk], s[3][kk]);
      __syncthreads();

      // acc[i][kc][e] += sum_j p[4ty + i][j] * v[j][4tx + 32kc + e]
      for (int j = 0; j < nkeys; ++j) {
        const float4 p =
            *reinterpret_cast<const float4*>(Pt + j * FA_PSTRIDE + 4 * ty);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + j * FA_STRIDE + 4 * tx + 32 * kc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][kc][0] += pr[i] * vv.x;
            acc[i][kc][1] += pr[i] * vv.y;
            acc[i][kc][2] += pr[i] * vv.z;
            acc[i][kc][3] += pr[i] * vv.w;
          }
        }
      }
    }
  }

  T* ob = out + (bh * Sq + q_start) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(fk::FULL_MASK, lt, 1);
    lt += __shfl_xor_sync(fk::FULL_MASK, lt, 2);
    lt += __shfl_xor_sync(fk::FULL_MASK, lt, 4);
    const float den = fmaxf(lt, 1e-30f);
    const int r = 4 * ty + i;
    if (r >= q_blk) continue;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const int c = 4 * tx + 32 * kc;
      if (c < D)
        fk::store4(ob + (long long)r * D + c,
                   make_float4(acc[i][kc][0] / den, acc[i][kc][1] / den,
                               acc[i][kc][2] / den, acc[i][kc][3] / den));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Skv, int D, int q_blk, int kv_blk, int causal,
           void* stream) {
  if (BH == 0 || Sq == 0) return 0;
  if (D > FA_DMAX || D % 4 != 0 || q_blk > FA_BQ || Sq % q_blk != 0 ||
      Skv % kv_blk != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = FA_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Sq / q_blk, BH);
  flash_attention_kernel<T><<<grid, FA_THREADS, smem,
                              (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, D, q_blk,
      kv_blk, causal, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* out, int BH,
                                          int Sq, int Skv, int D, int q_blk,
                                          int kv_blk, int causal,
                                          void* stream) {
  return launch<float>(q, k, v, out, BH, Sq, Skv, D, q_blk, kv_blk, causal,
                       stream);
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* out, int BH,
                                           int Sq, int Skv, int D, int q_blk,
                                           int kv_blk, int causal,
                                           void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, BH, Sq, Skv, D, q_blk, kv_blk,
                               causal, stream);
}
