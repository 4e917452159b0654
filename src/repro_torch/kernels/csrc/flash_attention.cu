// flash_attention_{bf16,f32}_kernel - attention forward with an online
// softmax, causal or not, on the H100's tensor cores (kernel E).
//
// Replaces the TPU kernel `_flash_kernel` of the JAX package
// (repro/kernels/flash_attention.py). Plain version: `ref.flash_attention`
// in repro_torch/kernels/ref.py; wrapper: repro_torch/kernels/flash_attention.py.
//
// q [BH, Sq, D], k/v [BH, Skv, D] (bfloat16 or float32, kv GQA-expanded,
// D a multiple of 4, at most 128 in bf16 and 224 in f32) -> [BH, Sq, D] of
// q's dtype. q and kv
// blocks of min(128, S) rows as the TPU kernel's (the models' route,
// `flash_attention_ragged`, pads q to such blocks and passes a key block
// of 1: keys of any length, see `launch`); causal means
// qpos >= kpos counted from 0, masked scores are -1e30, the softmax is
// taken in float32 and out = acc / max(l, 1e-30). Under causality a kv
// tile is skipped by the rows it lies wholly above (a warpgroup's 64 rows
// in bf16, a warp's 16 in f32); the TPU kernel skips the same keys at
// 128-key granularity, and skipped keys weigh exactly 0 either way.
//
// Bound by operations: a causal prefill at S=4096, D=128 does 4·D flops
// for each of S(S+1)/2 (q, k) pairs a head against 4·S·D elements moved.
// Both types run those operations on the tensor cores:
//
// * bf16 - `wgmma` m64n128k16 with float32 accumulation: S = Q·Kᵀ with
//   both operands in shared memory, O += P·V with P from registers and V
//   read transposed (MN-major). One block of two warpgroups per (head,
//   128-row q block), each warpgroup owning 64 q rows; kv tiles of 128
//   keys. Q, K and V sit in shared memory in the 128-byte swizzled layout
//   (D zero-padded to 128): a warp's copies then read whole lines and
//   write eight bank groups; in the no-swizzle core-matrix layout they
//   read eight half lines, and the kernel ran 27 % slower at the prefill
//   shape (benchmarks_torch/flash_variants.py).
//   P stays in registers: the S accumulator's fragment packs pairwise into
//   the A fragment of the next `wgmma`. P is split into P_hi = bf16(p) and
//   P_lo = bf16(p - P_hi) and multiplied twice: a single bf16 rounding of
//   P puts the output one bf16 rounding of P away from the float32
//   plain version, which the bf16 bar (one rounding of the output) does
//   not admit on every element; the split leaves a 2^-16 relative error.
// * f32 - 3xTF32 on `mma.sync.m16n8k8` (a_lo·b_hi + a_hi·b_lo + a_hi·b_hi,
//   the two small products first, each part rounded to the nearest TF32
//   value): single-pass TF32 misses the float32 bar (2e-5) by ~40x, and
//   the TF32 `wgmma` takes B only K-major while V is MN-major. Eight warps
//   of 16 q rows share the block's tiles of 64 keys, stored row-major with
//   a padded stride (D <= 128; wider heads: tiles of 32 keys, rows
//   permuted by 16-byte chunks instead of padded, see `FPlan`). The C fragment of m16n8k8 does not map onto its A
//   fragment (a lane holds keys 2t, 2t+1 of S but columns t, t+4 of A), so
//   instead of moving P across lanes the P·V product's k index is
//   permuted: A's k-slot t is key 2t and slot t+4 is key 2t+1, and V's B
//   fragment is read from shared memory in the same order.
//
// Both: 256 threads; K/V tiles in a two-stage ring filled by `cp.async`
// (zero-fill past the last row), the next tile's copies issued while the
// tensor cores take S (their issue stalls while the copy queue is full);
// Q once with tile 0. The row max, exp2 (MUFU.EX2) with scale·log2(e)
// folded in, and the row sum run on the accumulator fragments; a row's
// four owner lanes reduce by two shuffles. The q blocks of a head are
// issued heaviest first (the last causal block reads the most tiles).
//
// Given an `lse` pointer (the trainable route), the f32 kernel also writes
// each query row's log-sum-exp of its scaled scores, m·scale + log(l), as
// float32 [BH, Sq]: what the backward (flash_attention_bwd.cu) recomputes
// P from. Without one (every other call) nothing else changes.
#include <cstdint>
#include <type_traits>

#include "float_common.cuh"

namespace {

constexpr int FA_THREADS = 256;
constexpr int FA_BQ = 128;   // query rows a block: the TPU kernel's block
constexpr int BF_KT = 128;  // keys a kv tile, bf16
constexpr int F_KT = 64;    // keys a kv tile, f32 at D <= 128
constexpr int FA_DMAX = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- cp.async
// `src_bytes` 0 writes zeros and reads nothing (rows past the tensor)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero_smem(unsigned char* smem, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += FA_THREADS * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
}

// Tile start row, rows a tile, rows of it present in the tensor.
__device__ __forceinline__ int tile_rows(int row0, int rows, int n) {
  return max(0, min(rows, n - row0));
}

// ======================================================= bf16 with wgmma
// A tile of R rows x 128 bf16 columns in the 128-byte swizzled layout of
// `wgmma`: two halves of 64 columns, each R rows of 128 bytes, the 16-byte
// chunk j of row r stored at chunk j ^ (r % 8) (every half 1024-byte
// aligned). Element (r, c) sits at byte
//   (c / 64) * R * 128 + r * 128 + (((c / 8) % 8) ^ (r % 8)) * 16 + (c % 8) * 2.
// Eight threads copy one 128-byte row segment: whole lines from device
// memory, eight different bank groups in shared memory.
constexpr int SW_ROW = 128;   // bytes a row of a half
constexpr int SW_ATOM = 1024; // 8 rows: the swizzle's period
constexpr int BF_Q_BYTES = FA_BQ * 2 * SW_ROW;    // 32 KB
constexpr int BF_TILE_BYTES = BF_KT * 2 * SW_ROW;
constexpr int BF_SMEM =
    BF_Q_BYTES + 4 * BF_TILE_BYTES + SW_ATOM;  // + alignment

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
// K-major (Q as A, K as B; D contiguous): the stride offset steps 8 rows,
// the leading one is unused; a k16 step advances the start by 32 bytes
// inside the swizzle row, and by a half past column 64. MN-major (V as B
// of P·V, transposed; D contiguous): the leading offset steps from one
// 64-column half of N to the next, the stride offset 8 rows of K (keys).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// R rows of `src` from row `row0` (`n` rows present) into a swizzled tile
// at `dst`; rows past `n` are zero-filled. 16-byte copies where
// D % 8 == 0, 8-byte ones where D % 8 == 4; chunks past D are not copied.
template <int R>
__device__ __forceinline__ void load_bf16(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int row0, int n, int D) {
  const int present = tile_rows(row0, R, n);
  const __nv_bfloat16* base = src + (long long)row0 * D;
  if (D % 8 == 0) {  // 16 chunks of 16 bytes a row
#pragma unroll
    for (int it = 0; it < R * 16 / FA_THREADS; ++it) {
      const int i = threadIdx.x + it * FA_THREADS;
      const int c = i & 15, r = i >> 4;
      const bool ok = r < present;
      if (c < D / 8)
        cp_async16(dst + (c >> 3) * R * SW_ROW + r * SW_ROW +
                       (((c & 7) ^ (r & 7)) << 4),
                   ok ? base + (long long)r * D + c * 8 : src, ok ? 16 : 0);
    }
  } else {  // 32 chunks of 8 bytes a row
#pragma unroll
    for (int it = 0; it < R * 32 / FA_THREADS; ++it) {
      const int i = threadIdx.x + it * FA_THREADS;
      const int c = i & 31, r = i >> 5, c16 = c >> 1;
      const bool ok = r < present;
      if (c < D / 4)
        cp_async8(dst + (c16 >> 3) * R * SW_ROW + r * SW_ROW +
                      (((c16 & 7) ^ (r & 7)) << 4) + (c & 1) * 8,
                  ok ? base + (long long)r * D + c * 4 : src, ok ? 8 : 0);
    }
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers that a `wgmma` reads or writes at this point of the
// program: before `wg_fence` the compiler may not sink their definitions
// past it (ptxas would then serialize the `wgmma`s), after the wait it
// may not hoist their reads above it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FA_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define FA_F16(a, i) \
  FA_F4(a, i), FA_F4(a, i + 4), FA_F4(a, i + 8), FA_F4(a, i + 12)
#define FA_F32(a, i) FA_F16(a, i), FA_F16(a, i + 16)

// s[0..63] += Q(64 x 16, smem) · K(16 x 128, smem)ᵀ
__device__ __forceinline__ void wgmma_qk(float (&s)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_F32(s, 0), FA_F32(s, 32)
      : "l"(da), "l"(db), "r"(1));
}

// o[0..63] += P(64 x 16, registers) · V(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_pv(float (&o)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : FA_F32(o, 0), FA_F32(o, 32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// x0, x1 (x0 in the low half) as P_hi = bf16(x) and P_lo = bf16(x - P_hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x for x <= 0 (MUFU.EX2, relative error ~2^-22; results below 2^-126
// flush to 0, which no sum of at least 1 can see)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step shared by both kernels, for the two rows a
// thread owns (r = 0: its row g, r = 1: row g + 8) over NJ chunks of 8
// keys, element e of chunk j at s[4j + 2r + e] (the accumulator fragment
// of both `wgmma` and `mma.sync`): masks, takes the new max, turns the
// scores into probabilities in place and returns each row's rescale.
// FOLD computes (x - m)·c as one fused x·c - m·c: one instruction less a
// score, at a rounding of m·c (~2^-24 of it) in the exponent, which bf16
// does not see; float32 keeps the exact difference.
template <int NJ, bool FOLD>
__device__ __forceinline__ void online_softmax(float* s, float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2], bool mask,
                                               int causal, int key0, int Skv,
                                               int qpos0, float c) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + e;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (key >= Skv || (causal && key > qpos0 + 8 * r))
            s[4 * j + 2 * r + e] = fk::NEG_INF;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fk::NEG_INF;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(fk::FULL_MASK, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(fk::FULL_MASK, mx, 2));
    const float m_new = fmaxf(m[r], mx), mc = m_new * c;
    alpha[r] = exp2_approx((m[r] - m_new) * c);
    m[r] = m_new;
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * r + e];
        x = exp2_approx(FOLD ? fmaf(x, c, -mc) : (x - m_new) * c);
        sum[e] += x;
      }
    l[r] = l[r] * alpha[r] + (sum[0] + sum[1]);
  }
}

// The tile loop both kernels share: Q with tile 0, then a two-stage K/V
// ring. `compute(stage, key0, prefetch)` runs once every copy of tile n
// has landed and been made visible to the async proxy (`wgmma` reads
// through it) and to every thread; it calls `prefetch()`, the copies of
// tile n + 1 into the other stage, once, where their issue costs least:
// it stalls while the copy queue is full, so beside tensor-core work. A
// stage is refilled only after the whole block is done with it.
template <int KT, typename LoadQ, typename LoadKV, typename Compute>
__device__ __forceinline__ void tile_loop(int n_tiles, LoadQ load_q,
                                          LoadKV load_kv, Compute compute) {
  load_q();
  load_kv(0, 0);
  cp_commit();
  for (int n = 0; n < n_tiles; ++n) {
    cp_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    compute(n & 1, n * KT, [&] {
      if (n + 1 < n_tiles) load_kv((n + 1) & 1, (n + 1) * KT);
    });
    cp_commit();
    __syncthreads();
  }
}

template <int KT>
__device__ __forceinline__ int tiles_needed(int Skv, int q_start, int q_blk,
                                            int causal) {
  const int n = (Skv + KT - 1) / KT;
  return causal ? min(n, (q_start + q_blk - 1) / KT + 1) : n;
}

__global__ void __launch_bounds__(FA_THREADS, 1) flash_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int Sq, int Skv, int D, int q_blk, int causal, float c) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle is taken from address bits 4-9: align to its period
  unsigned char* smem =
      smem_raw + ((SW_ATOM - smem_u32(smem_raw) % SW_ATOM) % SW_ATOM);
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + BF_Q_BYTES;         // two stages
  const uint32_t s_v = s_k + 2 * BF_TILE_BYTES;  // two stages

  const int qi = Sq / q_blk - 1 - (int)blockIdx.x;
  const long long bh = blockIdx.y;
  const int q_start = qi * q_blk;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int row0 = 64 * wg + 16 * warp + g;  // this thread's rows: +0, +8
  const bool wg_has_rows = 64 * wg < q_blk;
  const int wg_first = q_start + 64 * wg;
  const int wg_last = q_start + min(64 * wg + 63, q_blk - 1);
  const __nv_bfloat16* qb = q + (bh * Sq + q_start) * D;
  const __nv_bfloat16* kb = k + bh * Skv * D;
  const __nv_bfloat16* vb = v + bh * Skv * D;

  if (D < FA_DMAX) {  // columns past D are never copied: make them zeros
    zero_smem(smem, BF_SMEM - SW_ATOM);
    __syncthreads();
  }

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {fk::NEG_INF, fk::NEG_INF}, l[2] = {0.f, 0.f};

  tile_loop<BF_KT>(
      tiles_needed<BF_KT>(Skv, q_start, q_blk, causal),
      [&] { load_bf16<FA_BQ>(s_q, qb, 0, q_blk, D); },
      [&](int st, int key0) {
        load_bf16<BF_KT>(s_k + st * BF_TILE_BYTES, kb, key0, Skv, D);
        load_bf16<BF_KT>(s_v + st * BF_TILE_BYTES, vb, key0, Skv, D);
      },
      [&](int st, int key0, auto prefetch) {
        if (!wg_has_rows || (causal && key0 > wg_last)) {
          prefetch();
          return;
        }
        float s[BF_KT / 2];
#pragma unroll
        for (int i = 0; i < BF_KT / 2; ++i) s[i] = 0.f;
        const uint32_t q0 = s_q + wg * 64 * SW_ROW;
        const uint32_t k0 = s_k + st * BF_TILE_BYTES;
        fence_regs(s);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < FA_DMAX / 16; ++kk) {  // 32 bytes a k16 step
          const uint32_t off = (kk & 3) * 32;
          wgmma_qk(s,
                   wg_desc(q0 + (kk >> 2) * FA_BQ * SW_ROW + off, 16,
                           SW_ATOM),
                   wg_desc(k0 + (kk >> 2) * BF_KT * SW_ROW + off, 16,
                           SW_ATOM));
        }
        wg_commit();
        prefetch();  // the next tile, while the tensor cores take S
        wg_wait();
        fence_regs(s);

        float alpha[2];
        const bool mask = key0 + BF_KT > Skv ||
                          (causal && key0 + BF_KT - 1 > wg_first);
        online_softmax<BF_KT / 8, true>(s, m, l, alpha, mask, causal,
                                        key0 + 2 * t, Skv, q_start + row0, c);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        // P = P_hi + P_lo as the A fragments of the k16 steps: register i
        // of step kk holds s[8kk + 2i], s[8kk + 2i + 1]
        uint32_t ph[BF_KT / 4], pl[BF_KT / 4];
#pragma unroll
        for (int i = 0; i < BF_KT / 4; ++i)
          split_bf16(s[2 * i], s[2 * i + 1], ph[i], pl[i]);
        const uint64_t dv = wg_desc(s_v + st * BF_TILE_BYTES,
                                    BF_KT * SW_ROW, SW_ATOM);
        fence_regs(o);
        fence_regs(ph);
        fence_regs(pl);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BF_KT / 16; ++kk) {  // 16 keys: 2 atoms
          const uint64_t d = dv + kk * (2 * SW_ATOM >> 4);
          wgmma_pv(o, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                   ph[4 * kk + 3], d);
          wgmma_pv(o, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                   pl[4 * kk + 3], d);
        }
        wg_commit();
        wg_wait();
        fence_regs(o);
      });

  if (!wg_has_rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(fk::FULL_MASK, lt, 1);
    lt += __shfl_xor_sync(fk::FULL_MASK, lt, 2);
    const float den = fmaxf(lt, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= q_blk) continue;
    __nv_bfloat16* orow = out + (bh * Sq + q_start + row) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / den,
                                  o[4 * j + 2 * r + 1] / den);
    }
  }
}

// ==================================================== f32 with 3xTF32
// Two plans of the same kernel, by head width. D <= 128: row-major tiles
// of 132 floats a row (16-byte rows for cp.async; the fragment reads
// below hit 32 different banks) and kv tiles of 64 keys. 128 < D <= 224:
// the padded rows of 228 floats would not fit Q and the two-stage ring in
// shared memory even at 32 keys a tile, so rows keep 224 floats and each
// row's 16-byte chunks are permuted by XOR with (row & 7) (`FPlan::at`):
// a stride of 224 puts every row on bank 0, and the permutation spreads
// the fragment reads of rows r..r+7 over 32 banks again. Q, 128 rows, and
// kv tiles of 32 keys: 229,376 bytes.
template <int DMAX, int KT, bool SWZ>
struct FPlan {
  static constexpr int STRIDE = SWZ ? DMAX : DMAX + 4;
  static constexpr int Q_FLOATS = FA_BQ * STRIDE;
  static constexpr int TILE_FLOATS = KT * STRIDE;
  static constexpr int SMEM = (Q_FLOATS + 4 * TILE_FLOATS) * 4;
  // the float offset of (row, col) in a tile
  static __device__ __forceinline__ int at(int row, int col) {
    return row * STRIDE + (SWZ ? col ^ ((row & 7) << 2) : col);
  }
  // at(row, c + 4) - at(row, c) for a column c of bit 2 clear: the
  // permutation keeps rows eight apart in step, and moves column c + 4
  // back by 4 in an odd row
  static __device__ __forceinline__ int plus4(int row) {
    return SWZ && (row & 1) ? -4 : 4;
  }
};
using F128 = FPlan<FA_DMAX, F_KT, false>;  // 202,752 B
using F224 = FPlan<224, 32, true>;       // 229,376 B

template <int R, typename PL>
__device__ __forceinline__ void load_f32(uint32_t dst, const float* src,
                                         int row0, int n, int D) {
  constexpr int CH = (PL::STRIDE - (PL::STRIDE % 8)) / 4;  // chunks a row
  const int present = tile_rows(row0, R, n);
  const float* base = src + (long long)row0 * D;
#pragma unroll
  for (int it = 0; it < R * CH / FA_THREADS; ++it) {
    const int i = threadIdx.x + it * FA_THREADS;
    // (a row of 32 chunks by shifts, as the 128-column plan always took it)
    const int r = CH == 32 ? i >> 5 : i / CH, c = CH == 32 ? i & 31 : i % CH;
    const bool ok = r < present;
    if (c < D / 4)
      cp_async16(dst + PL::at(r, c * 4) * 4,
                 ok ? base + (long long)r * D + c * 4 : src, ok ? 16 : 0);
  }
}

// x rounded to the nearest TF32 value, ties away from zero: the result
// of cvt.rna.tf32.f32 for finite x, in two integer operations (ptxas
// expands the cvt into compares and selects for the special values,
// which cost the f32 kernel ~0.9 ms at the prefill shape:
// benchmarks_torch/flash_variants.py)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, each rounded to the nearest TF32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3xTF32: the two small products first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int DMAX, int KT, bool SWZ>
__global__ void __launch_bounds__(FA_THREADS, 1) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Sq, int Skv,
    int D, int q_blk, int causal, float c, float* __restrict__ lse) {
  using PL = FPlan<DMAX, KT, SWZ>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Qs = reinterpret_cast<const float*>(smem);
  const float* Ks = Qs + PL::Q_FLOATS;         // two stages
  const float* Vs = Ks + 2 * PL::TILE_FLOATS;  // two stages

  const int qi = Sq / q_blk - 1 - (int)blockIdx.x;
  const long long bh = blockIdx.y;
  const int q_start = qi * q_blk;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int row0 = 16 * warp + g;  // this thread's rows: +0, +8
  const bool warp_has_rows = 16 * warp < q_blk;
  const int warp_first = q_start + 16 * warp;
  const int warp_last = q_start + min(16 * warp + 15, q_blk - 1);
  const float* qb = q + (bh * Sq + q_start) * D;
  const float* kb = k + bh * Skv * D;
  const float* vb = v + bh * Skv * D;

  if (D < DMAX) {  // columns past D are never copied: make them zeros
    zero_smem(smem, PL::SMEM);
    __syncthreads();
  }

  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {fk::NEG_INF, fk::NEG_INF}, l[2] = {0.f, 0.f};

  tile_loop<KT>(
      tiles_needed<KT>(Skv, q_start, q_blk, causal),
      [&] { load_f32<FA_BQ, PL>(smem_u32(Qs), qb, 0, q_blk, D); },
      [&](int st, int key0) {
        load_f32<KT, PL>(smem_u32(Ks + st * PL::TILE_FLOATS), kb, key0, Skv,
                         D);
        load_f32<KT, PL>(smem_u32(Vs + st * PL::TILE_FLOATS), vb, key0, Skv,
                         D);
      },
      [&](int st, int key0, auto prefetch) {
        prefetch();
        if (!warp_has_rows || (causal && key0 > warp_last)) return;
        const float* Kt = Ks + st * PL::TILE_FLOATS;
        const float* Vt = Vs + st * PL::TILE_FLOATS;
        float s[KT / 8][4];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        // S = Q·Kᵀ over k steps of 8 columns
#pragma unroll
        for (int ks = 0; ks < DMAX / 8; ++ks) {
          const float* qr = Qs + PL::at(row0, 8 * ks + t);
          const int q4 = PL::plus4(row0);
          uint32_t ah[4], al[4];
          split_tf32(qr[0], ah[0], al[0]);
          split_tf32(qr[8 * PL::STRIDE], ah[1], al[1]);
          split_tf32(qr[q4], ah[2], al[2]);
          split_tf32(qr[8 * PL::STRIDE + q4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            const float* kr = Kt + PL::at(8 * j + g, 8 * ks + t);
            mma_3xtf32(s[j], ah, al, kr[0], kr[PL::plus4(g)]);
          }
        }
        float alpha[2];
        const bool mask = key0 + KT > Skv ||
                          (causal && key0 + KT - 1 > warp_first);
        online_softmax<KT / 8, false>(&s[0][0], m, l, alpha, mask, causal,
                                      key0 + 2 * t, Skv, q_start + row0, c);
#pragma unroll
        for (int j = 0; j < DMAX / 8; ++j) {
          o[j][0] *= alpha[0];
          o[j][1] *= alpha[0];
          o[j][2] *= alpha[1];
          o[j][3] *= alpha[1];
        }
        // O += P·V, k steps of 8 keys with the k index permuted: A's slot
        // t is key 2t (s[j][0], s[j][2]), slot t + 4 is key 2t + 1
        // (s[j][1], s[j][3]); V's B fragment rows follow.
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          uint32_t ph[4], pl[4];
          split_tf32(s[j][0], ph[0], pl[0]);
          split_tf32(s[j][2], ph[1], pl[1]);
          split_tf32(s[j][1], ph[2], pl[2]);
          split_tf32(s[j][3], ph[3], pl[3]);
          const int r0 = 8 * j + 2 * t;
          const float* vr = Vt + r0 * PL::STRIDE + g;
#pragma unroll
          for (int cc = 0; cc < DMAX / 8; ++cc) {
            if constexpr (SWZ)  // the row's permutation moves each column
              mma_3xtf32(o[cc], ph, pl, Vt[PL::at(r0, g + 8 * cc)],
                         Vt[PL::at(r0 + 1, g + 8 * cc)]);
            else
              mma_3xtf32(o[cc], ph, pl, vr[8 * cc], vr[PL::STRIDE + 8 * cc]);
          }
        }
      });

  if (!warp_has_rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(fk::FULL_MASK, lt, 1);
    lt += __shfl_xor_sync(fk::FULL_MASK, lt, 2);
    const float den = fmaxf(lt, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= q_blk) continue;
    float* orow = out + (bh * Sq + q_start + row) * D;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[j][2 * r] / den, o[j][2 * r + 1] / den);
    }
    // ln(sum exp(s·scale)) = (m·c + log2(l))·ln(2), with c = scale·log2(e)
    if (lse != nullptr && t == 0)
      lse[bh * Sq + q_start + row] =
          (m[r] * c + log2f(den)) * 0.6931471805599453f;
  }
}

// q_blk must divide Sq; kv_blk is not used by the kernels, only checked
// against Skv (the TPU kernel's contract, which `flash_attention` keeps).
// Any Skv is computed exactly: `tiles_needed` rounds up, `load_bf16` /
// `load_f32` copy the rows below Skv and zero-fill the rest (a zero-size
// `cp.async` reads nothing), and `online_softmax` masks every key >= Skv,
// so a key block of 1 (the models' route) takes ragged lengths.
// `lse` (f32 only; null for no log-sum-exp) is [BH, Sq] float32. `dmax`
// is the widest head the kernel's plan takes.
template <typename T, typename Kernel>
int launch(Kernel kernel, int smem, int dmax, const void* q, const void* k,
           const void* v, void* out, void* lse, int BH, int Sq, int Skv,
           int D, int q_blk, int kv_blk, int causal, void* stream) {
  if (BH == 0 || Sq == 0) return 0;
  if (D > dmax || D % 4 != 0 || q_blk < 1 || q_blk > FA_BQ ||
      Sq % q_blk != 0 || kv_blk < 1 || Skv % kv_blk != 0 ||
      (!std::is_same_v<T, float> && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // scores are taken raw; exp2 of (s - m) * scale * log2(e)
  const float c = (float)(1.4426950408889634 / sqrt((double)D));
  const dim3 grid(Sq / q_blk, BH);
  if constexpr (std::is_same_v<T, float>)
    kernel<<<grid, FA_THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, D, q_blk,
        causal, c, (float*)lse);
  else
    kernel<<<grid, FA_THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, D, q_blk,
        causal, c);
  return (int)cudaGetLastError();
}

// the f32 kernel of the plan that takes D: 128 or 224 columns
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int BH, int Sq, int Skv, int D, int q_blk,
               int kv_blk, int causal, void* stream) {
  if (D <= FA_DMAX)
    return launch<float>(flash_attention_f32_kernel<FA_DMAX, F_KT, false>,
                         F128::SMEM, FA_DMAX, q, k, v, out, lse, BH, Sq, Skv,
                         D, q_blk, kv_blk, causal, stream);
  return launch<float>(flash_attention_f32_kernel<224, 32, true>, F224::SMEM,
                       224, q, k, v, out, lse, BH, Sq, Skv, D, q_blk, kv_blk,
                       causal, stream);
}

}  // namespace

extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* out, int BH,
                                          int Sq, int Skv, int D, int q_blk,
                                          int kv_blk, int causal,
                                          void* stream) {
  return launch_f32(q, k, v, out, nullptr, BH, Sq, Skv, D, q_blk, kv_blk,
                    causal, stream);
}

// the same, also writing each query row's log-sum-exp into `lse`
extern "C" int flash_attention_f32_lse_launch(const void* q, const void* k,
                                              const void* v, void* out,
                                              void* lse, int BH, int Sq,
                                              int Skv, int D, int q_blk,
                                              int kv_blk, int causal,
                                              void* stream) {
  return launch_f32(q, k, v, out, lse, BH, Sq, Skv, D, q_blk, kv_blk, causal,
                    stream);
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* out, int BH,
                                           int Sq, int Skv, int D, int q_blk,
                                           int kv_blk, int causal,
                                           void* stream) {
  return launch<__nv_bfloat16>(flash_attention_bf16_kernel, BF_SMEM, FA_DMAX,
                               q, k, v, out, nullptr, BH, Sq, Skv, D, q_blk,
                               kv_blk, causal, stream);
}
