// flash_bwd_{di,dkdv,dq}_f32_kernel - the gradient of kernel E's float32
// attention, tile by tile from the forward's saved output and log-sum-exp.
//
// Replaces no TPU kernel: the JAX package differentiates its oracle
// (`jax.custom_vjp` around `_flash_kernel`, whose backward is autograd of
// `ref.flash_attention`), and so did the port, through the plain attention
// with its [BH, Sq, Skv] scores. Plain version:
// `flash_attention_backward_torch` in repro_torch/kernels/flash_attention.py,
// which repeats these tile walks; wrapper: `flash_attention_backward` there.
//
// q, out, dout [BH, Sq, D]; k, v [BH, Skv, D]; lse [BH, Sq] (each query
// row's log of the sum of exp(score·scale), E's forward writes it) ->
// dq [BH, Sq, D], dk, dv [BH, Skv, D], float32, kv GQA-expanded, D <= 224
// and a multiple of 4, any Sq, Skv >= 1. Masking is E's: causal means
// qpos >= kpos counted from 0; keys at or past Skv and query rows at or
// past Sq weigh 0. With z = q·kᵀ·scale, P = exp(z - lse), Di = rowsum(dout ∘
// out), dP = dout·vᵀ and dS = P ∘ (dP - Di):
//   dv = Pᵀ·dout,  dk = dSᵀ·q·scale,  dq = dS·k·scale.
//
// Bound by operations: a causal call needs 7 products over the S(S+1)/2
// unmasked pairs a head (2·D flops each): P and dP twice, once in each
// kernel, then dv, dk and dq. Every product is 3xTF32 on `mma.sync.m16n8k8`
// (a_lo·b_hi + a_hi·b_lo + a_hi·b_hi), as in E's float32 forward: single-pass
// TF32 misses the float32 bar and the configurations train in float32.
//
// * `flash_bwd_di_f32_kernel`: Di, a warp a row.
// * `flash_bwd_dkdv_f32_kernel`: a block a (head, 128-key tile), eight warps
//   of 16 keys. K and V stay in shared memory; the query tiles stream
//   through a two-stage `cp.async` ring from the diagonal down (tiles wholly
//   above it are never read, a warp skips a tile whose every query lies
//   before its keys). A warp takes Sᵀ = K·Qᵀ and dPᵀ = V·doutᵀ with the keys
//   as the M dimension, so P and dS land in the C fragment with a key a row,
//   and feed dv += Pᵀ·dout and dk += dSᵀ·q as A fragments with E's permuted
//   k index (A's slot t is query 2t, slot t + 4 query 2t + 1; the B rows of
//   dout and q follow) - nothing crosses lanes.
// * `flash_bwd_dq_f32_kernel`: a block a (head, 128-row query tile), eight
//   warps of 16 rows, q and dout in shared memory, the key tiles streaming
//   up to the diagonal; S and dP as in E's forward, dq += dS·k with the
//   same permutation.
// Each output element is summed by one thread in a fixed order: no atomics,
// the same bits on every run. The tensor cores' float32 accumulation
// truncates at each `mma`, which biases a long sum toward zero: summed over
// 4096 queries in one register, dk and dv lay ~5e-5 of their largest
// magnitude from float64, ~15x the plain float32 autograd. So each thread
// adds its registers into its own output elements in device memory (plain
// float32 adds, L2-resident) and restarts them from zero every `FLUSH_ROWS`
// streamed rows. Tiles are row-major with a stride of D + 4
// floats (fragment reads hit 32 banks) and D padded with zeros to 64 where
// D <= 64, else to 128: the streamed tiles hold 64 rows at 64 columns, 32
// at 128, so either plan fits its shared memory once a block. Wider heads
// (D <= 224) take blocks of 64 keys or query rows, streamed tiles of 32,
// and rows of 224 floats whose 16-byte chunks are permuted by XOR with
// (row & 7) instead of padded (as E's forward at that width): 229,888
// bytes. A warp's 16 rows then carry half of the output columns (dk and dv
// together would need 224 accumulators a thread), so two warps take the
// same rows, each computing P and dP whole and accumulating its half.
#include <cstdint>

#include "float_common.cuh"

namespace {

constexpr int FB_WARPS = 8;
constexpr int FB_THREADS = 32 * FB_WARPS;
constexpr int FB_ROWS = 128;     // keys of a dk/dv block, rows of a dq block
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FLUSH_ROWS = 256;  // streamed rows between flushes

// DC chunks of 8 columns: D padded to 8·DC; ROWS rows a block's fixed
// tiles, T a streamed tile; a warp's 16 rows accumulate DC / CS chunks of
// the output columns, CS warps a row group.
template <int DC>
struct Plan {
  static constexpr bool SWZ = DC > 16;  // permuted 8·DC-float rows
  static constexpr int S = SWZ ? 8 * DC : 8 * DC + 4;  // floats a row
  static constexpr int ROWS = SWZ ? 64 : FB_ROWS;
  static constexpr int T = SWZ ? 32 : 512 / DC;
  static constexpr int CS = FB_WARPS / (ROWS / 16);
  static constexpr int NC = DC / CS;  // accumulated chunks a warp
  // two fixed tiles of ROWS rows, two streamed tensors in two stages,
  // and (dk/dv) lse and Di of the streamed rows in two stages
  static constexpr int SMEM = ((2 * ROWS + 4 * T) * S + 4 * T) * 4;
  // the float offset of (row, col) in a tile
  static __device__ __forceinline__ int at(int row, int col) {
    return row * S + (SWZ ? col ^ ((row & 7) << 2) : col);
  }
  // at(row, c + 4) - at(row, c) for a column c of bit 2 clear (the
  // permutation moves column c + 4 back by 4 in an odd row)
  static __device__ __forceinline__ int plus4(int row) {
    return SWZ && (row & 1) ? -4 : 4;
  }
  // B operand (row, col) and (row + 1, col) of a permuted k step: rows
  // r and r + 1, column `col` of chunk `cc`
  template <typename F>
  static __device__ __forceinline__ void pair(const float* tile, int r,
                                              int g, int cc, F use) {
    if constexpr (SWZ) {
      use(tile[at(r, g + 8 * cc)], tile[at(r + 1, g + 8 * cc)]);
    } else {
      const float* p = tile + r * S + g;
      use(p[8 * cc], p[S + 8 * cc]);
    }
  }
};

// 2^x (MUFU.EX2, relative error ~2^-22), as E's forward takes it
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// R rows of `src` ([n, D] row-major) from row `row0` into `dst`, 16 bytes a
// copy; rows past `n` are zero-filled, columns past D are not copied.
template <int R, int DC>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n, int D) {
  constexpr int CH = 2 * DC;  // 16-byte chunks of a padded row
  const int present = max(0, min(R, n - row0));
  const float* base = src + (long long)row0 * D;
#pragma unroll
  for (int it = 0; it < R * CH / FB_THREADS; ++it) {
    const int i = threadIdx.x + it * FB_THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = r < present;
    if (c < D / 4)
      fk::cp_async16_zfill(dst + Plan<DC>::at(r, 4 * c),
                           ok ? base + (long long)r * D + 4 * c : src,
                           ok ? 16 : 0);
  }
}

__device__ __forceinline__ void zero_smem(float* smem, int bytes) {
  for (int i = threadIdx.x * 4; i < bytes / 4; i += FB_THREADS * 4)
    *reinterpret_cast<float4*>(smem + i) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// A fragment of rows r0 + g, r0 + g + 8 and columns 8ks + t, 8ks + t + 4 of
// a tile of plan PL, split into TF32 hi and lo parts
template <typename PL>
__device__ __forceinline__ void a_frag(const float* tile, int r0, int ks,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  // rows eight apart keep their permutation
  const float* p = tile + PL::at(r0 + g, 8 * ks + t);
  const int c4 = PL::plus4(r0 + g);
  const float a[4] = {p[0], p[8 * PL::S], p[c4], p[8 * PL::S + c4]};
  fk::split_a(a, ah, al);
}

// The accumulators acc[cc] (rows row0 + g, row0 + g + 8; columns col0 +
// 8cc + 2t, col0 + 8cc + 2t + 1) times `mul` into rows of `out` ([n, D],
// row-major), added to what is there (`add`) or written over it; rows past
// n and columns past D are left alone. The accumulators restart from zero.
template <int NC>
__device__ __forceinline__ void flush(float* out, int row0, int col0, int n,
                                      int D, float (&acc)[NC][4], float mul,
                                      bool add) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    float* orow = out + (long long)row * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = col0 + 8 * cc + 2 * t;
      if (row < n && col < D) {
        float2 x = make_float2(acc[cc][2 * r] * mul, acc[cc][2 * r + 1] * mul);
        if (add) {
          const float2 o = *reinterpret_cast<const float2*>(orow + col);
          x.x += o.x;
          x.y += o.y;
        }
        *reinterpret_cast<float2*>(orow + col) = x;
      }
      acc[cc][2 * r] = acc[cc][2 * r + 1] = 0.f;
    }
  }
}

// the C fragment c[j] (rows g, g + 8; columns 2t, 2t + 1 of chunk j) as the
// A fragment of a k step over that chunk's 8 columns, k index permuted
__device__ __forceinline__ void c_as_a(const float (&c)[4], uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  fk::split_a(a, ah, al);
}

__global__ void flash_bwd_di_f32_kernel(const float* __restrict__ out,
                                        const float* __restrict__ dout,
                                        float* __restrict__ di, long long rows,
                                        int D) {
  const long long row =
      ((long long)blockIdx.x * FB_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 a = fk::load4(out + row * D + c);
    const float4 b = fk::load4(dout + row * D + c);
    acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  acc = fk::warp_sum(acc);
  if (lane == 0) di[row] = acc;
}

template <int DC>
__global__ void __launch_bounds__(FB_THREADS, 1) flash_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int D,
    int causal, float c, float scale) {
  using P = Plan<DC>;
  constexpr int S = P::S, T = P::T, NC = P::NC;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + P::ROWS * S;
  float* Qs = Vs + P::ROWS * S;  // two stages
  float* Os = Qs + 2 * T * S;    // dout, two stages
  float* Ls = Os + 2 * T * S;    // lse, two stages
  float* Ds = Ls + 2 * T;        // Di, two stages

  const long long bh = blockIdx.y;
  const int key0 = blockIdx.x * P::ROWS;  // key tile 0, the heaviest, first
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  // the warp's 16 keys, and its first output chunk
  const int rw = P::CS == 1 ? warp : warp % (P::ROWS / 16);
  const int cc0 = P::CS == 1 ? 0 : warp / (P::ROWS / 16) * NC;
  const int wkey0 = key0 + 16 * rw;  // the warp's keys; a thread's: +g, +g+8
  const int n_qt = (Sq + T - 1) / T;
  const int qt0 = causal ? min(n_qt, key0 / T) : 0;
  const float* qb = q + bh * Sq * D;
  const float* ob = dout + bh * Sq * D;
  const float* lb = lse + bh * Sq;
  const float* db = di + bh * Sq;

  if (8 * DC > D) {  // columns past D are never copied: make them zeros
    zero_smem(smem, P::SMEM);
    __syncthreads();
  }
  load_rows<P::ROWS, DC>(Ks, k + bh * Skv * D, key0, Skv, D);
  load_rows<P::ROWS, DC>(Vs, v + bh * Skv * D, key0, Skv, D);
  auto load_q = [&](int st, int q0) {
    load_rows<T, DC>(Qs + st * T * S, qb, q0, Sq, D);
    load_rows<T, DC>(Os + st * T * S, ob, q0, Sq, D);
    if (tid < 2 * T) {
      const int r = tid % T;
      const bool ok = q0 + r < Sq;
      const float* src = tid < T ? lb : db;
      fk::cp_async4_zfill((tid < T ? Ls : Ds) + st * T + r,
                          ok ? src + q0 + r : src, ok ? 4 : 0);
    }
  };

  float dka[NC][4], dva[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  float* dkb = dk + bh * Skv * D;
  float* dvb = dv + bh * Skv * D;
  bool flushed = false;  // the outputs hold a partial sum

  if (qt0 < n_qt) load_q(0, qt0 * T);
  fk::cp_commit();
  for (int it = qt0; it < n_qt; ++it) {
    const int st = (it - qt0) & 1, q0 = it * T;
    fk::cp_wait<0>();
    __syncthreads();
    if (it + 1 < n_qt) load_q(st ^ 1, q0 + T);
    fk::cp_commit();
    if (wkey0 < Skv && !(causal && wkey0 > q0 + T - 1)) {
      const float* Qt = Qs + st * T * S;
      const float* Ot = Os + st * T * S;
      const float* Lt = Ls + st * T;
      const float* Dt = Ds + st * T;
      // Sᵀ = K·Qᵀ and dPᵀ = V·doutᵀ over k steps of 8 columns
      float s[T / 8][4], dp[T / 8][4];
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DC; ++ks) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        a_frag<P>(Ks, 16 * rw, ks, kh, kl);
        a_frag<P>(Vs, 16 * rw, ks, vh, vl);
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          const int off = P::at(8 * j + g, 8 * ks + t), c4 = P::plus4(g);
          fk::mma_3xtf32(s[j], kh, kl, Qt[off], Qt[off + c4]);
          fk::mma_3xtf32(dp[j], vh, vl, Ot[off], Ot[off + c4]);
        }
      }
      // P = exp(z - lse) and dS = P ∘ (dP - Di); element e of chunk j is
      // key wkey0 + g + 8(e / 2), query q0 + 8j + 2t + e % 2
      const bool mask = q0 + T > Sq || wkey0 + 16 > Skv ||
                        (causal && wkey0 + 15 > q0);
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lrow = (e & 1) ? l2.y : l2.x;
          float p = exp2_approx(fmaf(s[j][e], c, -lrow * LOG2E));
          if (mask) {
            const int key = wkey0 + g + 8 * (e >> 1);
            const int qpos = q0 + 8 * j + 2 * t + (e & 1);
            if (qpos >= Sq || key >= Skv || (causal && key > qpos)) p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // dv += Pᵀ·dout, dk += dSᵀ·q: k steps of 8 queries, permuted
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        c_as_a(s[j], ph, pl);
        c_as_a(dp[j], dh, dl);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          P::pair(Ot, 8 * j + 2 * t, g, cc0 + cc, [&](float b0, float b1) {
            fk::mma_3xtf32(dva[cc], ph, pl, b0, b1);
          });
          P::pair(Qt, 8 * j + 2 * t, g, cc0 + cc, [&](float b0, float b1) {
            fk::mma_3xtf32(dka[cc], dh, dl, b0, b1);
          });
        }
      }
    }
    if ((it - qt0) % (FLUSH_ROWS / T) == FLUSH_ROWS / T - 1 && it + 1 < n_qt) {
      flush<NC>(dkb, wkey0, 8 * cc0, Skv, D, dka, scale, flushed);
      flush<NC>(dvb, wkey0, 8 * cc0, Skv, D, dva, 1.f, flushed);
      flushed = true;
    }
    __syncthreads();
  }
  fk::cp_wait<0>();  // a tile wholly above the diagonal ran no loop
  flush<NC>(dkb, wkey0, 8 * cc0, Skv, D, dka, scale, flushed);
  flush<NC>(dvb, wkey0, 8 * cc0, Skv, D, dva, 1.f, flushed);
}

template <int DC>
__global__ void __launch_bounds__(FB_THREADS, 1) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dq, int Sq, int Skv, int D, int causal, float c,
    float scale) {
  using P = Plan<DC>;
  constexpr int S = P::S, T = P::T, NC = P::NC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + P::ROWS * S;  // dout
  float* Ks = Os + P::ROWS * S;  // two stages
  float* Vs = Ks + 2 * T * S;    // two stages

  const long long bh = blockIdx.y;
  const int n_qb = (Sq + P::ROWS - 1) / P::ROWS;
  const int q0 = (n_qb - 1 - (int)blockIdx.x) * P::ROWS;  // heaviest first
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  // the warp's 16 rows, and its first output chunk
  const int rw = P::CS == 1 ? warp : warp % (P::ROWS / 16);
  const int cc0 = P::CS == 1 ? 0 : warp / (P::ROWS / 16) * NC;
  const int qw0 = q0 + 16 * rw;  // this warp's rows; a thread's: +g, +g+8
  const int last = min(q0 + P::ROWS, Sq) - 1;  // the block's last row
  int n_kt = (Skv + T - 1) / T;
  if (causal) n_kt = min(n_kt, last / T + 1);
  const float* kb = k + bh * Skv * D;
  const float* vb = v + bh * Skv * D;

  float lrow[2], drow[2];  // lse·log2(e) and Di of the thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw0 + g + 8 * r;
    lrow[r] = row < Sq ? lse[bh * Sq + row] * LOG2E : 0.f;
    drow[r] = row < Sq ? di[bh * Sq + row] : 0.f;
  }

  if (8 * DC > D) {
    zero_smem(smem, P::SMEM);
    __syncthreads();
  }
  load_rows<P::ROWS, DC>(Qs, q + bh * Sq * D, q0, Sq, D);
  load_rows<P::ROWS, DC>(Os, dout + bh * Sq * D, q0, Sq, D);
  auto load_kv = [&](int st, int key0) {
    load_rows<T, DC>(Ks + st * T * S, kb, key0, Skv, D);
    load_rows<T, DC>(Vs + st * T * S, vb, key0, Skv, D);
  };

  float dqa[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
  float* dqb = dq + bh * Sq * D;
  bool flushed = false;

  load_kv(0, 0);
  fk::cp_commit();
  for (int n = 0; n < n_kt; ++n) {
    const int st = n & 1, key0 = n * T;
    fk::cp_wait<0>();
    __syncthreads();
    if (n + 1 < n_kt) load_kv(st ^ 1, key0 + T);
    fk::cp_commit();
    if (qw0 < Sq && !(causal && key0 > qw0 + 15)) {
      const float* Kt = Ks + st * T * S;
      const float* Vt = Vs + st * T * S;
      // S = Q·Kᵀ and dP = dout·Vᵀ over k steps of 8 columns
      float s[T / 8][4], dp[T / 8][4];
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DC; ++ks) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        a_frag<P>(Qs, 16 * rw, ks, qh, ql);
        a_frag<P>(Os, 16 * rw, ks, oh, ol);
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          const int off = P::at(8 * j + g, 8 * ks + t), c4 = P::plus4(g);
          fk::mma_3xtf32(s[j], qh, ql, Kt[off], Kt[off + c4]);
          fk::mma_3xtf32(dp[j], oh, ol, Vt[off], Vt[off + c4]);
        }
      }
      // element e of chunk j is row qw0 + g + 8(e / 2), key key0 + 8j +
      // 2t + e % 2
      const bool mask = key0 + T > Skv || qw0 + 16 > Sq ||
                        (causal && key0 + T - 1 > qw0);
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(s[j][e], c, -lrow[e >> 1]));
          if (mask) {
            const int row = qw0 + g + 8 * (e >> 1);
            const int key = key0 + 8 * j + 2 * t + (e & 1);
            if (row >= Sq || key >= Skv || (causal && key > row)) p = 0.f;
          }
          dp[j][e] = p * (dp[j][e] - drow[e >> 1]);
        }
      // dq += dS·k: k steps of 8 keys, permuted
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        uint32_t dh[4], dl[4];
        c_as_a(dp[j], dh, dl);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          P::pair(Kt, 8 * j + 2 * t, g, cc0 + cc, [&](float b0, float b1) {
            fk::mma_3xtf32(dqa[cc], dh, dl, b0, b1);
          });
      }
    }
    if (n % (FLUSH_ROWS / T) == FLUSH_ROWS / T - 1 && n + 1 < n_kt) {
      flush<NC>(dqb, qw0, 8 * cc0, Sq, D, dqa, scale, flushed);
      flushed = true;
    }
    __syncthreads();
  }
  flush<NC>(dqb, qw0, 8 * cc0, Sq, D, dqa, scale, flushed);
}

template <int DC>
int launch_plan(const float* q, const float* k, const float* v,
                const float* dout, const float* lse, const float* di,
                float* dq, float* dk, float* dv, int BH, int Sq, int Skv,
                int D, int causal, cudaStream_t stream) {
  constexpr int smem = Plan<DC>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<DC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  // scores are taken raw: P = exp2(z·scale·log2(e) - lse·log2(e))
  const float c = (float)(1.4426950408889634 / sqrt((double)D));
  const float scale = (float)(1.0 / sqrt((double)D));
  constexpr int rows = Plan<DC>::ROWS;
  flash_bwd_dkdv_f32_kernel<DC>
      <<<dim3((Skv + rows - 1) / rows, BH), FB_THREADS, smem, stream>>>(
          q, k, v, dout, lse, di, dk, dv, Sq, Skv, D, causal, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_f32_kernel<DC>
      <<<dim3((Sq + rows - 1) / rows, BH), FB_THREADS, smem, stream>>>(
          q, k, v, dout, lse, di, dq, Sq, Skv, D, causal, c, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// `di` is scratch of BH·Sq floats; every other pointer is as the note above
// says. Returns a CUDA error code (0: all three kernels launched).
extern "C" int flash_attention_bwd_f32_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* di, void* dq, void* dk,
    void* dv, int BH, int Sq, int Skv, int D, int causal, void* stream) {
  if (BH == 0) return 0;
  if (D < 4 || D > 224 || D % 4 != 0 || Sq < 1 || Skv < 1 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)BH * Sq;
  // Di: a warp a row
  flash_bwd_di_f32_kernel<<<(unsigned)((rows + FB_WARPS - 1) / FB_WARPS),
                            FB_THREADS, 0, s>>>(
      (const float*)out, (const float*)dout, (float*)di, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto args = [&](auto launch) {
    return launch((const float*)q, (const float*)k, (const float*)v,
                  (const float*)dout, (const float*)lse, (const float*)di,
                  (float*)dq, (float*)dk, (float*)dv, BH, Sq, Skv, D, causal,
                  s);
  };
  return D <= 64    ? args(launch_plan<8>)
         : D <= 128 ? args(launch_plan<16>)
                    : args(launch_plan<28>);
}
