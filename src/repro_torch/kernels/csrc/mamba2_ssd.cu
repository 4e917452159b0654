// mamba2_ssd_kernel - Mamba2 SSD (state-space duality) chunked forward
// (kernel F), chunks in parallel on the tensor cores.
//
// Replaces the TPU kernel `_ssd_kernel` of the JAX package
// (repro/kernels/mamba2_ssd.py). Plain version: `ref.mamba2_ssd` in
// repro_torch/kernels/ref.py; wrapper: repro_torch/kernels/mamba2_ssd.py.
//
// x [B, S, H, P], dt [B, S, H], A [H], B/C [B, S, G, N] (G groups of H/G
// consecutive heads; G = 1 is one B and C for every head), all float32 ->
// y [B, S, H, P] and, where asked for, the final state h_{nc-1}
// [B, H, P, N] (what a Mamba layer's prefill hands to its decode). Per (batch, chunk c of L tokens, head), with cum the
// within-chunk cumulative sum of dt * A[h], total = cum[L-1], dtx = dt * x:
//   y[i] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dtx_j      (diagonal)
//          + exp(cum_i) (C_i . h_{c-1})                      (carried state)
//   S_c  = sum_l exp(total - cum_l) dtx_l (x) B_l          (chunk's own state)
//   h_c  = h_{c-1} exp(total) + S_c                  (h_{-1} = 0, [P, N])
//
// Bound by operations (`mamba2_ssd.operations`: ~33 GFLOP at mamba2-130m
// widths against 0.44 GB moved). The plain version's decomposition, on the
// H100's tensor cores:
//
// * Chunks in parallel. A block owns one (batch, chunk) and `hpb` heads
//   of one B/C group; B and C are shared by the group's heads, so C.B^T -
//   the largest product - is computed once a block, on its lower
//   triangle (warp w: rows 16w..16w+15, columns below 16(w+1)), and kept
//   in shared memory in fragment order. Then, head by head: the chunk's
//   state S_c, W = C.B^T o exp(cum_i - cum_j) o [j <= i] (the decay
//   evaluated only where j <= i: above the diagonal it overflows, and
//   inf * 0 is NaN), y = W.dtx, and the carried term, taken transposed as
//   h_{c-1}.C^T so that h is the A operand, held in registers.
// * The state is carried by a decoupled look-back. Blocks take a ticket
//   from a counter, chunk-major, so a block waits only on blocks that
//   started before it: the block of chunk c waits for flag[b][h] >= c,
//   reads h_{c-1} (from L2, past L1), writes h_c = h_{c-1} exp(total) +
//   S_c into a ring of two states per (batch, head) and raises the flag
//   to c + 1 (a barrier, then one thread's fence and release store, as a
//   grid barrier does) - before its y products, so the chain waits on
//   loads, not on math. The last chunk's block writes its h_c to the
//   final-state output instead, when the caller passes one. Every read of h_{c-1} (the update and the
//   registers for h.C^T) precedes the flag, and chunk c + 1 writes slot
//   (c - 1) & 1 only after it, so two slots suffice.
// * Every product is 3xTF32 on mma.sync.m16n8k8 (a_lo.b_hi + a_hi.b_lo +
//   a_hi.b_hi, each part rounded to the nearest TF32 value), as the f32
//   flash kernel does: float32 accuracy at the tensor-core rate. For
//   W.dtx the C fragment of C.B^T is used as the A fragment with the k
//   index permuted (slot t is column 2t, slot t + 4 column 2t + 1) and
//   dtx's B fragment read in the same order, so no value crosses lanes.
//   dt multiplies x where x is read, so x is copied as it is.
// * One block of 8 warps an SM: C [L][N+4], B [L][N+8] and x [L][P+4]
//   (after W.dtx it stages y for coalesced stores), strides chosen so the
//   fragment reads hit 32 banks, C.B^T's fragments, and the block's dt:
//   214,528 bytes of dynamic shared memory at 8 heads a block. C.B^T in
//   registers instead (64 a thread) left ptxas no room to overlap the
//   products: 1.59 against 1.36 ms (benchmarks_torch/ssd_variants.py).
// * cum is a warp scan; decays and exp(cum) are taken once a head.
#include <cstdint>

#include "float_common.cuh"

namespace {

constexpr int SSD_THREADS = 256;
constexpr int SSD_MAXL = 128, SSD_MAXP = 64, SSD_MAXN = 128;
constexpr int CST = SSD_MAXN + 4;  // C rows: fragment reads at 4g + t
constexpr int BST = SSD_MAXN + 8;  // B rows: S's B fragments at 8t + g
constexpr int XST = SSD_MAXP + 4;  // x rows: W.dtx's B fragments at 8t + g
constexpr int CB_TILES = 72;       // sum over warps w of 2(w + 1) n-tiles
constexpr int SSD_MAX_HPB = 32;
// C, B, x, C.B^T, cum, ecum, dte; then dt of the block's heads [L][hpb]
constexpr int SSD_SMEM_FLOATS = SSD_MAXL * (CST + BST + XST) +
                                CB_TILES * 128 + 3 * SSD_MAXL;  // 210,432 B

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__global__ void __launch_bounds__(SSD_THREADS, 1) mamba2_ssd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ hfin, float* ring, int* flags, int Bsz, int S, int H,
    int G, int P, int N, int L, int hpb) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                 // [L][CST]
  float* Bs = Cs + SSD_MAXL * CST;  // [L][BST]
  float* X = Bs + SSD_MAXL * BST;   // [L][XST]: x of the head, then y
  float* CBf = X + SSD_MAXL * XST;  // C.B^T fragments: [tile][lane][4]
  float* cum = CBf + CB_TILES * 128;  // [L]
  float* ecum = cum + SSD_MAXL;       // [L] exp(cum), 0 past L
  float* dte = ecum + SSD_MAXL;       // [L] exp(total - cum), 0 past L
  float* dtb = dte + SSD_MAXL;        // [hpb][L] dt of the block's heads
  __shared__ int s_ticket;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // a block's heads lie in one B/C group: `gblk` blocks a group
  const int Hg = H / G, gblk = (Hg + hpb - 1) / hpb;
  const int nc = S / L, ngrp = G * gblk;
  if (tid == 0) s_ticket = atomicAdd(flags, 1);
  for (int i = tid * 4; i < SSD_SMEM_FLOATS + SSD_MAXL * hpb;
       i += SSD_THREADS * 4)
    *reinterpret_cast<float4*>(smem + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // chunk-major tickets: every block this one waits on started before it
  const int ticket = s_ticket;
  const int c = ticket / (Bsz * ngrp);
  const int b = (ticket - c * Bsz * ngrp) / ngrp;
  const int blk = ticket - c * Bsz * ngrp - b * ngrp;
  const int grp = blk / gblk, hg0 = (blk - grp * gblk) * hpb;
  const int h0 = grp * Hg + hg0;
  const int hn = min(hpb, Hg - hg0);
  const long long row0 = (long long)b * S + (long long)c * L;  // token
  const int n4 = N / 4, p4 = P / 4;
  const int LK = (L + 7) / 8;  // k steps over L

  for (int i = tid; i < L * n4; i += SSD_THREADS) {
    const int l = i / n4, cc = (i - l * n4) * 4;
    const long long src = ((row0 + l) * G + grp) * N + cc;
    fk::cp_async16(Cs + l * CST + cc, Cm + src);
    fk::cp_async16(Bs + l * BST + cc, Bm + src);
  }
  fk::cp_commit();
  for (int i = tid; i < L * hn; i += SSD_THREADS) {
    const int l = i / hn, k = i - l * hn;
    dtb[k * SSD_MAXL + l] = dt[(row0 + l) * H + h0 + k];
  }
  fk::cp_wait<0>();
  __syncthreads();

  // C.B^T once for the block: warp w, rows 16w + g (+8), n-tiles < 2(w+1),
  // kept in shared memory in fragment order (tile, lane, 4 values)
  const int mi = warp;
  float* cbw = CBf + mi * (mi + 1) * 128 + 4 * lane;
  if (16 * mi < L) {
    float cb[16][4];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      cb[k][0] = cb[k][1] = cb[k][2] = cb[k][3] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < (N + 7) / 8; ++ks) {
      const float* cr = Cs + (16 * mi + g) * CST + 8 * ks + t;
      const float a[4] = {cr[0], cr[8 * CST], cr[4], cr[8 * CST + 4]};
      uint32_t ah[4], al[4];
      fk::split_a(a, ah, al);
#pragma unroll
      for (int nq = 0; nq < 4; ++nq) {
        if (2 * nq < mi + 1) {  // n-tiles 4nq .. 4nq + 3 reach the diagonal
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* br = Bs + (8 * (4 * nq + e) + g) * BST + 8 * ks + t;
            fk::mma_3xtf32(cb[4 * nq + e], ah, al, br[0], br[4]);
          }
        }
      }
    }
#pragma unroll
    for (int kt = 0; kt < 16; ++kt)
      if (kt < 2 * (mi + 1))
        *reinterpret_cast<float4*>(cbw + kt * 128) =
            make_float4(cb[kt][0], cb[kt][1], cb[kt][2], cb[kt][3]);
  }

  // S_c and C.h^T tiles: p rows 16mp + g (+8); S's n / C.h^T's i half nh
  const int mp = warp & 3, nh = warp >> 2;
  const bool p_on = 16 * mp < P;
  const bool first = c == 0, last = c == nc - 1;

#pragma unroll 1
  for (int hi = 0; hi < hn; ++hi) {
    const int h = h0 + hi;
    const float a = A[h];
    for (int i = tid; i < L * p4; i += SSD_THREADS) {
      const int l = i / p4, pp = (i - l * p4) * 4;
      fk::cp_async16(X + l * XST + pp, x + ((row0 + l) * H + h) * P + pp);
    }
    fk::cp_commit();
    const float* dts = dtb + hi * SSD_MAXL;
    if (warp == 0) {  // cum: a warp scan, four steps a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = 4 * lane + e;
        run += l < L ? __fmul_rn(dts[l], a) : 0.f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(fk::FULL_MASK, incl, off);
        if (lane >= off) incl += n;
      }
      float excl = __shfl_up_sync(fk::FULL_MASK, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * lane + e < L) cum[4 * lane + e] = excl + v[e];
    }
    __syncthreads();
    const float total = cum[L - 1];
    for (int l = tid; l < L; l += SSD_THREADS) {
      ecum[l] = expf(cum[l]);
      dte[l] = expf(total - cum[l]);
    }
    fk::cp_wait<0>();
    __syncthreads();  // x of head h and the decays are in shared memory

    // S_c[p][n] = sum_l (dt_l x_l dte_l)[p] B_l[n]: n-tiles 8nh .. 8nh + 7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if (p_on) {
#pragma unroll 2
      for (int ks = 0; ks < LK; ++ks) {
        const int l0 = 8 * ks + t, l1 = l0 + 4;
        const float* x0 = X + l0 * XST + 16 * mp + g;
        const float* x1 = X + l1 * XST + 16 * mp + g;
        const float d0 = dts[l0], e0 = dte[l0], d1 = dts[l1], e1 = dte[l1];
        const float a4[4] = {x0[0] * d0 * e0, x0[8] * d0 * e0, x1[0] * d1 * e1,
                             x1[8] * d1 * e1};
        uint32_t ah[4], al[4];
        fk::split_a(a4, ah, al);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int nt = 8 * nh + j;
          fk::mma_3xtf32(s[j], ah, al, Bs[l0 * BST + 8 * nt + g],
                         Bs[l1 * BST + 8 * nt + g]);
        }
      }
    }

    // the carried state: wait for h_{c-1}, publish h_c
    const float etot = expf(total);
    const size_t hstride = (size_t)P * N;
    const size_t slot0 = ((size_t)b * H + h) * 2;
    int* flag = flags + 1 + b * H + h;
    // h_{c-1}[16mp + g (+8)][8ks + t (+4)]: the A fragments of h.C^T
    float ha[16][4];
#pragma unroll
    for (int ks = 0; ks < 16; ++ks)
      ha[ks][0] = ha[ks][1] = ha[ks][2] = ha[ks][3] = 0.f;
    if (!first) {
      if (tid == 0)
        while (ld_acquire(flag) < c) __nanosleep(64);
      __syncthreads();
      const float* hp = ring + (slot0 + ((c - 1) & 1)) * hstride;
      if (p_on) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = 16 * mp + g + 8 * r;
          if (p < P) {
            const float* hr = hp + p * N;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int n = 8 * (8 * nh + j) + 2 * t;
              if (n < N) {
                const float2 hv = __ldcg(reinterpret_cast<const float2*>(hr + n));
                s[j][2 * r] = fmaf(hv.x, etot, s[j][2 * r]);
                s[j][2 * r + 1] = fmaf(hv.y, etot, s[j][2 * r + 1]);
              }
            }
#pragma unroll
            for (int ks = 0; ks < 16; ++ks) {
              const int n = 8 * ks + t;
              if (n < N) ha[ks][r] = __ldcg(hr + n);
              if (n + 4 < N) ha[ks][2 + r] = __ldcg(hr + n + 4);
            }
          }
        }
      }
    }
    // h_c into the ring for chunk c + 1, or the last one into hfin
    float* const hlast = hfin ? hfin + ((size_t)b * H + h) * hstride : nullptr;
    if ((!last || hlast) && p_on) {
      float* hp = last ? hlast : ring + (slot0 + (c & 1)) * hstride;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * (8 * nh + j) + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = 16 * mp + g + 8 * r;
          if (n < N && p < P)
            __stcg(reinterpret_cast<float2*>(hp + p * N + n),
                   make_float2(s[j][2 * r], s[j][2 * r + 1]));
        }
      }
    }
    __syncthreads();
    if (!last && tid == 0) {
      __threadfence();  // the block's reads of h_{c-1} and writes of h_c
      st_release(flag, c + 1);
    }

    // y = W.dtx, W = C.B^T o exp(cum_i - cum_j) o [j <= i], rows 16mi..
    float yv[8][4];
#pragma unroll
    for (int pt = 0; pt < 8; ++pt)
      yv[pt][0] = yv[pt][1] = yv[pt][2] = yv[pt][3] = 0.f;
    if (16 * mi < L) {
      const int i0 = 16 * mi + g, i1 = i0 + 8;
      const float ci0 = cum[i0], ci1 = cum[i1];
#pragma unroll 2
      for (int kt = 0; kt < 2 * (mi + 1); ++kt) {
        const int j0 = 8 * kt + 2 * t, j1 = j0 + 1;
        const float cj0 = cum[j0], cj1 = cum[j1];
        const float d0 = dts[j0], d1 = dts[j1];
        const float4 cb = *reinterpret_cast<const float4*>(cbw + kt * 128);
        // A slot t <-> column 2t, slot t + 4 <-> column 2t + 1
        const float w[4] = {j0 <= i0 && i0 < L ? cb.x * expf(ci0 - cj0) : 0.f,
                            j0 <= i1 && i1 < L ? cb.z * expf(ci1 - cj0) : 0.f,
                            j1 <= i0 && i0 < L ? cb.y * expf(ci0 - cj1) : 0.f,
                            j1 <= i1 && i1 < L ? cb.w * expf(ci1 - cj1) : 0.f};
        uint32_t ah[4], al[4];
        fk::split_a(w, ah, al);
#pragma unroll
        for (int pt = 0; pt < 8; ++pt)
          fk::mma_3xtf32(yv[pt], ah, al, X[j0 * XST + 8 * pt + g] * d0,
                         X[j1 * XST + 8 * pt + g] * d1);
      }
    }
    __syncthreads();  // x is read: X stages y from here on
    if (16 * mi < L) {
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 16 * mi + g + 8 * r, p = 8 * pt + 2 * t;
          if (i < L && p < P)
            *reinterpret_cast<float2*>(X + i * XST + p) =
                make_float2(yv[pt][2 * r], yv[pt][2 * r + 1]);
        }
      }
    }
    __syncthreads();

    // y^T += (h_{c-1} . C^T) o exp(cum_i): p rows 16mp.., i-tiles 8nh..
    if (!first && p_on) {
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
    __syncthreads();  // y is read out of X before the next head's copies
  }
}

}  // namespace

// hfin: the final state [B, H, P, N] float32, or null (not written);
// ring: [B, H, 2, P, N] float32 scratch; flags: 1 + B*H int32, zeroed by
// the caller before each launch (the ticket counter, then one flag a
// (batch, head)); G: B/C groups, dividing H; hpb: heads a block.
extern "C" int mamba2_ssd_f32_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, void* y, void* hfin,
                                     void* ring, void* flags, int Bsz, int S,
                                     int H, int G, int P, int N, int L,
                                     int hpb, void* stream) {
  if (Bsz == 0 || H == 0 || S == 0) return 0;
  if (G < 1 || H % G != 0 || L <= 0 || S % L != 0 || L > SSD_MAXL ||
      P > SSD_MAXP ||
      N > SSD_MAXN || P % 4 != 0 || N % 4 != 0 || hpb < 1 ||
      hpb > SSD_MAX_HPB)
    return (int)cudaErrorInvalidValue;
  const int smem = (SSD_SMEM_FLOATS + SSD_MAXL * hpb) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = Bsz * (S / L) * G * ((H / G + hpb - 1) / hpb);
  mamba2_ssd_kernel<<<blocks, SSD_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (float*)y, (float*)hfin, (float*)ring, (int*)flags,
      Bsz, S, H, G, P, N, L, hpb);
  return (int)cudaGetLastError();
}
