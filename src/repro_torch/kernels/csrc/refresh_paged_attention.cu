// paged_attention_kernel - decode attention over an int8 paged KV cache
// with the dequantization fused into the page loop (kernel C).
//
// Replaces the TPU kernel `_paged_kernel` of the JAX package
// (repro/kernels/refresh_paged_attention.py). Plain version:
// `paged_attention_torch` in repro_torch/kernels/refresh_paged_attention.py.
//
// q [B, H, D] (float32 or bfloat16); k/v pages [P, T, Hkv, D] int8; scales
// [P, Hkv] f32; page_table [B, MAXP] i32; seq_lens [B] i32 -> [B, H, D] of
// q's dtype. Query head h reads kv head h / group. Only the first
// n_valid = ceil(seq_len / T) entries of a sequence's table row are read
// (clamped at 0, as the TPU kernel's page_map does); positions >= seq_len
// score -1e30; the result is acc / max(l, 1e-30), zeros for seq_len 0.
//
// Bound by bytes: the valid pages' int8 K and V are read once (a group
// of more than PA_MAXG query heads is split over blocks, each reading
// the kv head's pages). One block of PA_WARPS warps serves one
// (sequence, kv head) and up to PA_MAXG of its query heads. Warp w takes
// pages w, w + PA_WARPS, ... with its own online softmax (m, l, acc in
// registers), so PA_WARPS pages are in flight at once; the warps' states
// are merged through shared memory at the end. Inside a page, rows are
// taken 32 at a time, lane r owning row r for the scores: it reads the
// row's D int8 keys 16 to a load and computes every query head's whole
// dot product itself against q in shared memory (broadcast reads), so
// no score needs a reduction across the warp: a chain of five dependent
// shuffles for every row and head would bound the kernel by shuffle
// latency. For P.V each lane owns dims 4l..4l+3: the V rows are read as
// coalesced lines (4 bytes a lane, loads issued before the scores are
// computed) and each row's probabilities come from its lane by one
// shuffle. No dequantized value is written to device memory.
#include <stdint.h>

#include "float_common.cuh"

namespace {

constexpr int PA_WARPS = 8;
constexpr int PA_MAXG = 8;
constexpr int PA_MAXD = 128;

template <typename T>
__global__ void __launch_bounds__(PA_WARPS * 32) paged_attention_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kq,
    const int8_t* __restrict__ vq, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ page_table,
    const int* __restrict__ seq_lens, T* __restrict__ out, int H, int Hkv,
    int D, int Tn, int MAXP, float scale) {
  const int group = H / Hkv;
  // a block serves up to PA_MAXG query heads of one kv head: heads
  // h0 .. h0 + gn - 1, the kv head's slice blockIdx.x % nsl
  const int nsl = (group + PA_MAXG - 1) / PA_MAXG;
  const int g = blockIdx.x / nsl;  // kv head
  const int j0 = (blockIdx.x - g * nsl) * PA_MAXG;
  const int gn = min(PA_MAXG, group - j0);
  const int h0 = g * group + j0;
  const int b = blockIdx.y;  // sequence
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = lane * 4;
  const bool active = d0 < D;
  const int seq_len = seq_lens[b];
  int n_valid = seq_len > 0 ? (seq_len + Tn - 1) / Tn : 0;
  if (n_valid > MAXP) n_valid = MAXP;

  // this kv head's query heads, scaled by 1/sqrt(D), read by every lane
  __shared__ float4 sq[PA_MAXG][PA_MAXD / 4];
  for (int idx = threadIdx.x; idx < gn * (D / 4); idx += PA_WARPS * 32) {
    const int j = idx / (D / 4), c = idx - j * (D / 4);
    float4 v = fk::load4(q + ((long long)b * H + h0 + j) * D + 4 * c);
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    sq[j][c] = v;
  }
  __syncthreads();

  float m[PA_MAXG], l[PA_MAXG], acc[PA_MAXG][4];
#pragma unroll
  for (int j = 0; j < PA_MAXG; ++j) {
    m[j] = fk::NEG_INF;
    l[j] = 0.f;  // this lane's share of the sum; reduced at the end
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  const long long row_stride = (long long)Hkv * D;
  for (int pi = warp; pi < n_valid; pi += PA_WARPS) {
    const int phys = max(page_table[(long long)b * MAXP + pi], 0);
    const float ksc = ks[(long long)phys * Hkv + g];
    const float vsc = vs[(long long)phys * Hkv + g];
    const long long page_off = ((long long)phys * Tn * Hkv + g) * D;
    for (int t0 = 0; t0 < Tn; t0 += 32) {
      const int rows = min(32, Tn - t0);
      const bool present = lane < rows;
      // this chunk's V rows, one coalesced line each (4 bytes a lane),
      // issued before the scores so they arrive while those are computed
      char4 vr[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        vr[r] = make_char4(0, 0, 0, 0);
        if (active && r < rows)
          vr[r] = *reinterpret_cast<const char4*>(
              vq + page_off + (t0 + r) * row_stride + d0);
      }
      // lane r scores row t0 + r against every query head of the block:
      // the whole dot in one lane, 16 int8 a load, q from shared memory
      float sc[PA_MAXG];
#pragma unroll
      for (int j = 0; j < PA_MAXG; ++j) sc[j] = 0.f;
      if (present) {
        const int8_t* krow = kq + page_off + (t0 + lane) * row_stride;
        for (int c16 = 0; c16 < D / 16; ++c16) {
          const int4 w = *reinterpret_cast<const int4*>(krow + 16 * c16);
          const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // the word's four int8, sign-extended by arithmetic shifts
            const int u = words[e];
            const float k0 = (float)((u << 24) >> 24) * ksc;
            const float k1 = (float)((u << 16) >> 24) * ksc;
            const float k2 = (float)((u << 8) >> 24) * ksc;
            const float k3 = (float)(u >> 24) * ksc;
#pragma unroll
            for (int j = 0; j < PA_MAXG; ++j) {
              if (j < gn) {
                const float4 qv = sq[j][4 * c16 + e];
                sc[j] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
              }
            }
          }
        }
      }
      const bool valid = present && pi * Tn + t0 + lane < seq_len;
      float pr[PA_MAXG];
#pragma unroll
      for (int j = 0; j < PA_MAXG; ++j) {
        pr[j] = 0.f;
        if (j < gn) {
          const float s = valid ? sc[j] : fk::NEG_INF;
          const float m_new = fmaxf(m[j], fk::warp_max(s));
          const float alpha = expf(m[j] - m_new);
          pr[j] = present ? expf(s - m_new) : 0.f;
          l[j] = l[j] * alpha + pr[j];
          acc[j][0] *= alpha;
          acc[j][1] *= alpha;
          acc[j][2] *= alpha;
          acc[j][3] *= alpha;
          m[j] = m_new;
        }
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if (r >= rows) break;
        const float vv[4] = {(float)vr[r].x * vsc, (float)vr[r].y * vsc,
                             (float)vr[r].z * vsc, (float)vr[r].w * vsc};
#pragma unroll
        for (int j = 0; j < PA_MAXG; ++j) {
          if (j < gn) {
            const float p = __shfl_sync(fk::FULL_MASK, pr[j], r);
            acc[j][0] += p * vv[0];
            acc[j][1] += p * vv[1];
            acc[j][2] += p * vv[2];
            acc[j][3] += p * vv[3];
          }
        }
      }
    }
  }

  // merge the warps' online-softmax states
  __shared__ float sm_m[PA_WARPS][PA_MAXG];
  __shared__ float sm_l[PA_WARPS][PA_MAXG];
  __shared__ float sm_acc[PA_WARPS][PA_MAXG][PA_MAXD];
#pragma unroll
  for (int j = 0; j < PA_MAXG; ++j) {
    if (j < gn) {
      const float lsum = fk::warp_sum(l[j]);
      if (lane == 0) {
        sm_m[warp][j] = m[j];
        sm_l[warp][j] = lsum;
      }
      if (active) {
        sm_acc[warp][j][d0] = acc[j][0];
        sm_acc[warp][j][d0 + 1] = acc[j][1];
        sm_acc[warp][j][d0 + 2] = acc[j][2];
        sm_acc[warp][j][d0 + 3] = acc[j][3];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * D; idx += PA_WARPS * 32) {
    const int j = idx / D, d = idx - j * D;
    float mx = sm_m[0][j];
    for (int w = 1; w < PA_WARPS; ++w) mx = fmaxf(mx, sm_m[w][j]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < PA_WARPS; ++w) {
      const float f = expf(sm_m[w][j] - mx);
      lt += sm_l[w][j] * f;
      at += sm_acc[w][j][d] * f;
    }
    out[((long long)b * H + h0 + j) * D + d] =
        fk::from_f32<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kq, const void* vq, const void* ks,
           const void* vs, const void* table, const void* lens, void* out,
           int B, int H, int Hkv, int D, int Tn, int MAXP, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (H % Hkv != 0 || D > PA_MAXD || D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv * ((H / Hkv + PA_MAXG - 1) / PA_MAXG), B);
  paged_attention_kernel<T><<<grid, PA_WARPS * 32, 0,
                              (cudaStream_t)stream>>>(
      (const T*)q, (const int8_t*)kq, (const int8_t*)vq, (const float*)ks,
      (const float*)vs, (const int*)table, (const int*)lens, (T*)out, H,
      Hkv, D, Tn, MAXP, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_f32_launch(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* table, const void* lens, void* out, int B,
    int H, int Hkv, int D, int Tn, int MAXP, void* stream) {
  return launch<float>(q, kq, vq, ks, vs, table, lens, out, B, H, Hkv, D,
                       Tn, MAXP, stream);
}

extern "C" int paged_attention_bf16_launch(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* table, const void* lens, void* out, int B,
    int H, int Hkv, int D, int Tn, int MAXP, void* stream) {
  return launch<__nv_bfloat16>(q, kq, vq, ks, vs, table, lens, out, B, H,
                               Hkv, D, Tn, MAXP, stream);
}
