// paged_attention_split_kernel + paged_attention_merge_kernel - decode
// attention over an int8 paged KV cache with the dequantization fused into
// the page loop (kernel C), a sequence's pages split over blocks.
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
// Bound by bytes: the first seq_len rows of each sequence's int8 K and V
// are read once (a group of more than PA_MAXG query heads is split over
// blocks, each reading the kv head's pages). A decode step has few
// (sequence, kv head) pairs - 64 at Qwen2.5-14B with 8 sequences - so the
// pages of a sequence are split over blocks (flash-decoding): block
// (kv head x head slice, sequence, split) takes `split` pages and keeps
// an online softmax (m, l, acc) for up to PA_MAXG query heads; a second
// launch merges the splits' partial states. Splits past a sequence's
// pages return at once.
//
// Inside a block, rows of a page are taken PA_ROWS at a time (an item):
// the item's int8 K and V rows of the block's kv head (D bytes each,
// Hkv * D bytes apart in the cache) are copied by cp.async into a ring of
// PA_STAGES items in shared memory, so the next item's copies are in
// flight while one is computed. Per item: scores (two threads a row, each
// half of the row's 16-byte words, every query head of the block against
// q in shared memory), then one warp a head takes the item's max,
// rescales and writes p * v_scale, then P.V with each lane owning four
// dims of a quarter of the rows. The scales multiply the dot
// (s = k_scale q.k) and the probabilities (p v_scale), so no dequantized
// value is written to device memory. After the split the arithmetic, not the copies, is the limit:
// a clock64 probe finds an item's copies landed before they are waited
// for, so the ring is two items deep (43 KB a block, five blocks an SM),
// which ran faster than three or four
// (benchmarks_torch/paged_variants.py).
#include <stdint.h>

#include "float_common.cuh"

namespace {

constexpr int PA_THREADS = 128;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_MAXG = 8;     // query heads a block
constexpr int PA_MAXD = 128;
constexpr int PA_ROWS = 64;    // rows an item: two threads a row
constexpr int PA_STAGES = 2;   // items in the ring
constexpr int PA_PAD = 16;     // bytes after a staged row: 16-byte loads
                               // of 8 rows hit 32 banks

int split_smem_bytes(int D) {
  return PA_STAGES * 2 * PA_ROWS * (D + PA_PAD) +
         (PA_MAXG * PA_MAXD + PA_MAXG * PA_ROWS + PA_MAXG) * 4;
}

// four int8 (a word, lowest byte first) -> four floats
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  f[0] = (float)((int)(w << 24) >> 24);
  f[1] = (float)((int)(w << 16) >> 24);
  f[2] = (float)((int)(w << 8) >> 24);
  f[3] = (float)((int)w >> 24);
}

__device__ __forceinline__ int pages_valid(int seq_len, int Tn, int MAXP) {
  const int n = seq_len > 0 ? (seq_len + Tn - 1) / Tn : 0;
  return min(n, MAXP);
}

// Partial state of one split: part_acc [B, H, nsplit, D] (unnormalized,
// relative to the split's max), part_ml [B, H, nsplit, 2] (max, sum). G is
// min(group, PA_MAXG), so the per-head loops unroll without branches; a
// block's heads past its slice (a group wider than PA_MAXG and not a
// multiple of it) have q = 0 and are computed and dropped.
template <typename T, int G>
__global__ void __launch_bounds__(PA_THREADS) paged_attention_split_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kq,
    const int8_t* __restrict__ vq, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ page_table,
    const int* __restrict__ seq_lens, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int H, int Hkv, int D, int Tn, int MAXP,
    int split, int nsplit, float scale) {
  const int group = H / Hkv;
  const int nsl = (group + PA_MAXG - 1) / PA_MAXG;
  const int g = blockIdx.x / nsl;  // kv head
  const int j0 = (blockIdx.x - g * nsl) * PA_MAXG;
  const int gn = min(PA_MAXG, group - j0);
  const int h0 = g * group + j0;
  const int b = blockIdx.y, si = blockIdx.z;
  const int seq_len = seq_lens[b];
  const int n_valid = pages_valid(seq_len, Tn, MAXP);
  const int pg0 = si * split;
  if (pg0 >= n_valid) return;
  const int np = min(split, n_valid - pg0);
  // items: PA_ROWS-row pieces of the split's pages, in order, each with
  // at least one row below seq_len
  const int ipp = (Tn + PA_ROWS - 1) / PA_ROWS;
  auto item_pos = [&](int k) {
    return (pg0 + k / ipp) * Tn + (k % ipp) * PA_ROWS;
  };
  int n_items = np * ipp;
  while (item_pos(n_items - 1) >= seq_len) --n_items;

  extern __shared__ __align__(16) unsigned char smem[];
  const int RS = D + PA_PAD;
  unsigned char* ring = smem;
  float* sq = reinterpret_cast<float*>(ring + PA_STAGES * 2 * PA_ROWS * RS);
  float* ps = sq + PA_MAXG * PA_MAXD;  // [PA_MAXG][PA_ROWS] scores, then p
  float* salpha = ps + PA_MAXG * PA_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row_stride = (long long)Hkv * D;

  auto load_item = [&](int k) {
    const int pi = pg0 + k / ipp, r0 = (k % ipp) * PA_ROWS;
    const int rows = min(min(PA_ROWS, Tn - r0), seq_len - (pi * Tn + r0));
    const int phys = max(page_table[(long long)b * MAXP + pi], 0);
    const long long off = ((long long)phys * Tn + r0) * row_stride +
                          (long long)g * D;
    unsigned char* kd = ring + (k % PA_STAGES) * 2 * PA_ROWS * RS;
    unsigned char* vd = kd + PA_ROWS * RS;
    const int cpr = D / 16;
    for (int i = tid; i < rows * cpr; i += PA_THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      fk::cp_async16(kd + r * RS + 16 * c, kq + off + r * row_stride + 16 * c);
      fk::cp_async16(vd + r * RS + 16 * c, vq + off + r * row_stride + 16 * c);
    }
  };
#pragma unroll
  for (int s = 0; s < PA_STAGES - 1; ++s) {
    if (s < n_items) load_item(s);
    fk::cp_commit();
  }

  // this block's query heads, scaled by 1/sqrt(D); zeros past gn
  for (int idx = tid; idx < G * (D / 4); idx += PA_THREADS) {
    const int j = idx / (D / 4), c = idx - j * (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < gn) {
      v = fk::load4(q + ((long long)b * H + h0 + j) * D + 4 * c);
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
    }
    *reinterpret_cast<float4*>(sq + j * PA_MAXD + 4 * c) = v;
  }

  // scores: row r = 16 warp + (lane & 15), half = lane >> 4 of the row's
  // 16-byte words; P.V: rows 16 warp .. +15, dims 4 lane .. +3
  const int sr = 16 * warp + (lane & 15), half = lane >> 4;
  const int nw = D / 16, w_lo = half ? (nw + 1) / 2 : 0,
            w_hi = half ? nw : (nw + 1) / 2;
  const int d0 = 4 * lane;
  const bool dim_on = d0 < D;
  float m_run[2] = {fk::NEG_INF, fk::NEG_INF}, l_run[2] = {0.f, 0.f};
  float acc[G][4];
#pragma unroll
  for (int j = 0; j < G; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

#pragma unroll 1
  for (int k = 0; k < n_items; ++k) {
    fk::cp_wait<PA_STAGES - 2>();
    __syncthreads();  // item k landed; item k - 1's stage is free
    if (k + PA_STAGES - 1 < n_items) load_item(k + PA_STAGES - 1);
    fk::cp_commit();
    const int pi = pg0 + k / ipp, r0 = (k % ipp) * PA_ROWS;
    const int rows = min(min(PA_ROWS, Tn - r0), seq_len - (pi * Tn + r0));
    const int phys = max(page_table[(long long)b * MAXP + pi], 0);
    const float ksc = ks[(long long)phys * Hkv + g];
    const float vsc = vs[(long long)phys * Hkv + g];
    const unsigned char* kd = ring + (k % PA_STAGES) * 2 * PA_ROWS * RS;
    const unsigned char* vd = kd + PA_ROWS * RS;

    float sc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) sc[j] = 0.f;
    if (sr < rows) {
      for (int c = w_lo; c < w_hi; ++c) {
        const uint4 w = *reinterpret_cast<const uint4*>(kd + sr * RS + 16 * c);
        float kf[16];
        i8x4(w.x, kf);
        i8x4(w.y, kf + 4);
        i8x4(w.z, kf + 8);
        i8x4(w.w, kf + 12);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float4* qj =
              reinterpret_cast<const float4*>(sq + j * PA_MAXD + 16 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 qv = qj[e];
            sc[j] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] +
                     qv.z * kf[4 * e + 2] + qv.w * kf[4 * e + 3];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      sc[j] += __shfl_xor_sync(fk::FULL_MASK, sc[j], 16);
      if (half == 0)
        ps[j * PA_ROWS + sr] = sr < rows ? ksc * sc[j] : fk::NEG_INF;
    }
    __syncthreads();

    // online softmax: warp w takes heads w and w + PA_WARPS (those past
    // gn too: their p and alpha are finite and their sums are dropped)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = warp + PA_WARPS * u;
      if (j < G) {
        float* s = ps + j * PA_ROWS;
        const bool v0 = lane < rows, v1 = lane + 32 < rows;
        const float s0 = v0 ? s[lane] : fk::NEG_INF;
        const float s1 = v1 ? s[lane + 32] : fk::NEG_INF;
        const float m_new = fmaxf(m_run[u], fk::warp_max(fmaxf(s0, s1)));
        const float alpha = expf(m_run[u] - m_new);
        const float p0 = v0 ? expf(s0 - m_new) : 0.f;
        const float p1 = v1 ? expf(s1 - m_new) : 0.f;
        l_run[u] = l_run[u] * alpha + fk::warp_sum(p0 + p1);
        m_run[u] = m_new;
        s[lane] = p0 * vsc;
        s[lane + 32] = p1 * vsc;
        if (lane == 0) salpha[j] = alpha;
      }
    }
    __syncthreads();

    // acc = acc alpha + sum_r p_r v_scale v_r over this warp's 16 rows
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float al = salpha[j];
      acc[j][0] *= al;
      acc[j][1] *= al;
      acc[j][2] *= al;
      acc[j][3] *= al;
    }
    if (dim_on) {
#pragma unroll
      for (int rq = 0; rq < 16; rq += 4) {
        const int r = 16 * warp + rq;
        if (r < rows) {
          float vf[4][4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            i8x4(*reinterpret_cast<const uint32_t*>(vd + (r + e) * RS + d0),
                 vf[e]);
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float4 p =
                *reinterpret_cast<const float4*>(ps + j * PA_ROWS + r);
#pragma unroll
            for (int d = 0; d < 4; ++d)
              acc[j][d] += p.x * vf[0][d] + p.y * vf[1][d] + p.z * vf[2][d] +
                           p.w * vf[3][d];
          }
        }
      }
    }
  }

  // the warps' sums (one running max for all) -> the split's partial state
  fk::cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [PA_WARPS][PA_MAXG][D]
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < gn && dim_on)
      *reinterpret_cast<float4*>(red + (warp * PA_MAXG + j) * D + d0) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  __syncthreads();
  const long long base = ((long long)b * H + h0) * nsplit + si;
  for (int idx = tid; idx < gn * D; idx += PA_THREADS) {
    const int j = idx / D, d = idx - j * D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) a += red[(w * PA_MAXG + j) * D + d];
    part_acc[(base + (long long)j * nsplit) * D + d] = a;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = warp + PA_WARPS * u;
    if (j < gn && lane == 0) {
      part_ml[(base + (long long)j * nsplit) * 2] = m_run[u];
      part_ml[(base + (long long)j * nsplit) * 2 + 1] = l_run[u];
    }
  }
}

// One warp a (sequence, query head): the splits' states merged as one
// online softmax, out = acc / max(l, 1e-30) (zeros when no page is valid).
template <typename T>
__global__ void __launch_bounds__(32) paged_attention_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ seq_lens, T* __restrict__ out, int H, int D,
    int Tn, int MAXP, int split, int nsplit) {
  const int bh = blockIdx.x, b = bh / H, lane = threadIdx.x;
  const int ns = (pages_valid(seq_lens[b], Tn, MAXP) + split - 1) / split;
  const float* ml = part_ml + (long long)bh * nsplit * 2;
  float mx = fk::NEG_INF;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, ml[2 * s]);
  const int d0 = 4 * lane;
  if (d0 >= D) return;
  float lt = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < ns; ++s) {
    const float f = expf(ml[2 * s] - mx);
    lt += ml[2 * s + 1] * f;
    const float4 a = *reinterpret_cast<const float4*>(
        part_acc + ((long long)bh * nsplit + s) * D + d0);
    o[0] += a.x * f;
    o[1] += a.y * f;
    o[2] += a.z * f;
    o[3] += a.w * f;
  }
  const float den = fmaxf(lt, 1e-30f);
  fk::store4(out + (long long)bh * D + d0,
             make_float4(o[0] / den, o[1] / den, o[2] / den, o[3] / den));
}

template <typename T, int G>
int launch_split(dim3 grid, int smem, void* stream, const void* q,
                 const void* kq, const void* vq, const void* ks,
                 const void* vs, const void* table, const void* lens,
                 float* part_acc, float* part_ml, int H, int Hkv, int D,
                 int Tn, int MAXP, int split, int nsplit) {
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_split_kernel<T, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_split_kernel<T, G><<<grid, PA_THREADS, smem,
                                       (cudaStream_t)stream>>>(
      (const T*)q, (const int8_t*)kq, (const int8_t*)vq, (const float*)ks,
      (const float*)vs, (const int*)table, (const int*)lens, part_acc,
      part_ml, H, Hkv, D, Tn, MAXP, split, nsplit,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kq, const void* vq, const void* ks,
           const void* vs, const void* table, const void* lens, void* out,
           void* ws, int B, int H, int Hkv, int D, int Tn, int MAXP,
           int split, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (H % Hkv != 0 || D > PA_MAXD || D % 16 != 0 || Tn < 1 || MAXP < 0 ||
      split < 1)
    return (int)cudaErrorInvalidValue;
  const int nsplit = max(1, (MAXP + split - 1) / split);
  float* part_acc = (float*)ws;
  float* part_ml = part_acc + (long long)B * H * nsplit * D;
  const int smem = split_smem_bytes(D);
  const dim3 grid(Hkv * ((H / Hkv + PA_MAXG - 1) / PA_MAXG), B, nsplit);
  int err = 0;
#define PA_SPLIT_CASE(g)                                                   \
  case g:                                                                  \
    err = launch_split<T, g>(grid, smem, stream, q, kq, vq, ks, vs, table, \
                             lens, part_acc, part_ml, H, Hkv, D, Tn, MAXP, \
                             split, nsplit);                               \
    break;
  switch (min(H / Hkv, PA_MAXG)) {
    PA_SPLIT_CASE(1)
    PA_SPLIT_CASE(2)
    PA_SPLIT_CASE(3)
    PA_SPLIT_CASE(4)
    PA_SPLIT_CASE(5)
    PA_SPLIT_CASE(6)
    PA_SPLIT_CASE(7)
    PA_SPLIT_CASE(8)
  }
#undef PA_SPLIT_CASE
  if (err != 0) return err;
  paged_attention_merge_kernel<T><<<B * H, 32, 0, (cudaStream_t)stream>>>(
      part_acc, part_ml, (const int*)lens, (T*)out, H, D, Tn, MAXP, split,
      nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// ws: float32 scratch of B * H * max(1, ceil(MAXP / split)) * (D + 2)
// values
extern "C" int paged_attention_f32_launch(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* table, const void* lens, void* out, void* ws,
    int B, int H, int Hkv, int D, int Tn, int MAXP, int split, void* stream) {
  return launch<float>(q, kq, vq, ks, vs, table, lens, out, ws, B, H, Hkv,
                       D, Tn, MAXP, split, stream);
}

extern "C" int paged_attention_bf16_launch(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* table, const void* lens, void* out, void* ws,
    int B, int H, int Hkv, int D, int Tn, int MAXP, int split, void* stream) {
  return launch<__nv_bfloat16>(q, kq, vq, ks, vs, table, lens, out, ws, B,
                               H, Hkv, D, Tn, MAXP, split, stream);
}
