// sweep_mega_closed_kernel - the whole closed-loop tick loop (contract
// phases 0-5) of the sweep engine, a group of G lanes per cell, run to
// that cell's completion, with the integer stats reduced in the kernel.
//
// Replaces the TPU kernel `_mega_closed_kernel` / `_closed_call` of the
// JAX package (repro/kernels/sweep_megakernel.py). Plain version:
// `torchbody.closed_body` driven by `run_closed`
// (repro_torch/core/sweep/torchbody.py), reached through
// `mega_closed_cells` in repro_torch/kernels/sweep_megakernel.py.
//
// What bounds it: latency. Inputs and outputs are a few hundred bytes a
// cell and the arithmetic a few hundred integer operations a tick, but
// the ticks of one cell form a chain of small dependent steps. Run by one
// thread, every phase walks the banks or cores one after another; with
// the state in global memory that is ~300 dependent loads and stores,
// ~17,000 cycles a tick on a lone cell (H100).
//
// Why a group of lanes per cell. The serial walks are over banks and
// cores, so a cell is a group of G lanes (G the smallest power of two
// covering its banks and cores, 8 to 32; four cells share a warp at 8
// banks): lane b owns bank b and lane c core c. Each phase is then a few
// warp collectives over the group (sweep_tick.cuh), and the state a tick
// touches is on chip: a bank's and a core's words in their lane's
// registers, the subarray planes, the ring tails and the cores' MLP
// windows in the group's shared memory. What stays in global memory is
// touched once a request: the ring queues (B * LQ entries of 16 bytes, a
// bank's read only by its lane, each head once) and the latency
// histogram. The serial definition's orders are kept exactly:
//   * core issue in core order: a write takes buffer room by its rank
//     among this tick's eligible writers (`popc` of a ballot below the
//     lane), against the room left at the start of the tick; cores that
//     target one bank take consecutive ring slots in core order (the
//     offset is `popc` of `__match_any_sync` below the lane), and the
//     last of them advances the bank's tail; a cell deactivates, and
//     skips phases 2-5, on the tick its last core finishes;
//   * channels serve in channel order from scores taken before any serve;
//     two reads of one core served in one tick park in its first and
//     second free MLP-window slot, in channel order.
// Blocks stay resident and their groups take cells from a shared counter
// until none is left, so a group slot's ring and histogram are reused
// cell after cell and the scratch does not grow with the grid. Cells of
// more than 32 banks (or cores) run the wide instantiation: 32 lanes,
// each with up to SWEEP_MAX_BANKS / 32 bank (and core) slots.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_fields.h"
#include "sweep_tick.cuh"

#define SWEEP_WIDE (SWEEP_MAX_BANKS / 32)
#define SWEEP_WIDE_CORES (SWEEP_MAX_CORES / 32)

struct MegaClosedArgs {
  const int* params;       // [n, MEGA_NPARAM]
  const int* scn_of_cell;  // [n]
  const int *sw, *sb, *sr, *ssub, *sth;  // [NS, C, N] per-scenario streams
  const int* nreq;         // [NS, C]
  int* stats;              // [n, MEGA_NSTAT]
  int* core_finish;        // [n, C]
  int* ticks;              // [n] ticks this cell ran
  int4* ring;              // [slots, B * LQ] (arrive, row, sub, 2*core+w)
  int* hist;               // [slots, SWEEP_HIST_BINS], zeroed by the caller
  int* next_cell;          // one counter, zeroed by the caller
  int n;
  TickDims d;
  int C, N, K, LQ, CAP;
  int cell_words;          // shared words a cell
};

// Shared words of one cell: ref_until and open_row [S][BP], the ring
// tails [BP], per core the earliest parked return and the first free
// slot of its MLP window [C] each, and the windows [C][K].
__host__ __device__ inline int closed_cell_words(int BP, int S, int C,
                                                 int K) {
  return 2 * S * BP + BP + 2 * C + C * K;
}

__device__ __forceinline__ Head ring_head(int4 e) {
  return Head{e.y, e.z, e.x, e.w & 1, e.w >> 1};
}

template <int G, int NBL, int NCL>
__global__ void sweep_mega_closed_kernel(MegaClosedArgs a) {
  extern __shared__ int sweep_smem[];
  using M = Machine<G, NBL>;
  const Group<G> g = Group<G>::here();
  const int gi = threadIdx.x / G;
  const size_t slot = (size_t)blockIdx.x * (blockDim.x / G) + gi;
  const int B = a.d.B, S = a.d.S, C = a.C, N = a.N, K = a.K, LQ = a.LQ;
  const int QM = LQ - 1;
  int* sh = sweep_smem + gi * a.cell_words;
  // a bank's tail is advanced by its cores; a core's window is filled by
  // the banks that serve its reads, with the two words that summarize it:
  // `ret_min` (no return before it; PAD_ARRIVE: none) and `ret_free`
  // (the first free slot; K: none)
  int* q_tail = sh + 2 * S * M::BP;  // [BP]
  int* ret_min = q_tail + M::BP;     // [C]
  int* ret_free = ret_min + C;       // [C]
  int* comp_t = ret_free + C;        // [C][K]
  int4* ring = a.ring + slot * B * LQ;
  M m;
  m.g = g;
  m.d = a.d;
  m.place();
  m.ref_until = sh;
  m.open_row = sh + S * M::BP;
  m.hist = a.hist + slot * SWEEP_HIST_BINS;

  for (;;) {
    int cell = 0;
    if (g.lane == 0) cell = atomicAdd(a.next_cell, 1);
    cell = g.bcast(cell, 0);
    if (cell >= a.n) return;
    m.P = load_params(a.params + (size_t)cell * MEGA_NPARAM);
    const int scn = a.scn_of_cell[cell];
    const size_t soff = (size_t)scn * C * N;
    const int* sw = a.sw + soff;
    const int* sb = a.sb + soff;
    const int* sr = a.sr + soff;
    const int* ssub = a.ssub + soff;
    const int* sth = a.sth + soff;

    // ---- t = 0 state
    m.init();
    // a bank's queue head is read from the ring once: when the request
    // before it is served, or when it is appended to an empty queue (the
    // ring holds C * K + wbuf_cap + 1 entries or more, so a queued entry
    // is never overwritten)
    int q_head[NBL];
    bool head_ok[NBL];
    Head h[NBL];
#pragma unroll
    for (int j = 0; j < NBL; ++j) {
      q_head[j] = 0;
      head_ok[j] = false;
      q_tail[m.bank(j)] = 0;
    }
    // core slot jc of this lane is core lane + G*jc; `rq_*` is its next
    // request, fetched when the one before issues
    int n_req[NCL], next_idx[NCL], next_issue[NCL], out_reads[NCL];
    int remaining[NCL], finish[NCL];
    int rq_w[NCL], rq_b[NCL], rq_r[NCL], rq_s[NCL], rq_th[NCL];
    bool act = false;
#pragma unroll
    for (int jc = 0; jc < NCL; ++jc) {
      const int c = g.lane + G * jc;
      n_req[jc] = c < C ? a.nreq[(size_t)scn * C + c] : 0;
      next_idx[jc] = next_issue[jc] = out_reads[jc] = 0;
      remaining[jc] = n_req[jc];
      finish[jc] = n_req[jc] == 0 ? 0 : -1;
      act = act || n_req[jc] > 0;
      rq_w[jc] = rq_b[jc] = rq_r[jc] = rq_s[jc] = rq_th[jc] = 0;
      if (c < C) {
        for (int k = 0; k < K; ++k) comp_t[c * K + k] = PAD_ARRIVE;
        ret_min[c] = PAD_ARRIVE;
        ret_free[c] = 0;
        rq_w[jc] = sw[c * N];
        rq_b[jc] = sb[c * N];
        rq_r[jc] = sr[c * N];
        rq_s[jc] = ssub[c * N];
        rq_th[jc] = sth[c * N];
      }
    }
    g.sync();  // the tails and windows above are visible to the group
    bool active = g.any(act);

    int t = 0;
    while (active && t < m.P.horizon) {
      // ---- 0: outstanding-read completions
#pragma unroll
      for (int jc = 0; jc < NCL; ++jc) {
        const int c = g.lane + G * jc;
        // the window is walked only on a tick some return is due
        if (c >= C || ret_min[c] > t) continue;
        int* win = comp_t + c * K;
        int n_exp = 0, lo = PAD_ARRIVE, first = K;
#pragma unroll 8
        for (int k = 0; k < K; ++k) {
          int ct = win[k];
          if (ct <= t) {
            ct = PAD_ARRIVE;
            win[k] = ct;
            n_exp += 1;
          }
          if (ct != PAD_ARRIVE) lo = ct < lo ? ct : lo;
          else if (first == K) first = k;
        }
        ret_min[c] = lo;
        ret_free[c] = first;
        out_reads[jc] -= n_exp;
        remaining[jc] -= n_exp;
      }

      // ---- 1: core issue, at most one per core per tick, in core order
      // (rounds of G cores; within a round, lane order)
      const int wroom = a.CAP - m.wpend;
      int writers = 0, n_wr = 0;
      bool appended = false;  // a ring entry written: sync before the banks
      act = false;
#pragma unroll
      for (int jc = 0; jc < NCL; ++jc) {
        if (G * jc >= C) break;
        const int c = g.lane + G * jc;
        const bool mine = c < C;
        const int idx = next_idx[jc];
        int rem = remaining[jc];
        const bool elig = mine && idx < n_req[jc] && next_issue[jc] <= t;
        const bool hw = elig && rq_w[jc] != 0;
        const unsigned wbits = g.ballot(hw);
        const bool issue =
            elig && (hw ? writers + __popc(wbits & g.below()) < wroom
                        : out_reads[jc] < m.P.mlp);
        writers += __popc(wbits);
        const unsigned ib = g.ballot(issue);
        n_wr += __popc(ib & wbits);
        appended = appended || ib != 0;
        const int hb = issue ? rq_b[jc] : -1;
        // with one issuer no other lane shares its bank
        const bool many = __popc(ib) > 1;
        const unsigned same = many ? g.match(hb) & ib : ib;
        const int tail = issue ? q_tail[hb] : 0;
        if (many) g.sync();  // every issuer read its tail before any update
        if (issue) {
          const int off = __popc(same & g.below()), cnt = __popc(same);
          ring[hb * LQ + ((tail + off) & QM)] =
              make_int4(t, rq_r[jc], rq_s[jc], (c << 1) | (hw ? 1 : 0));
          if (off == cnt - 1) q_tail[hb] = tail + cnt;
          if (hw) {
            rem -= 1;  // writes retire at issue
            remaining[jc] = rem;
          } else {
            out_reads[jc] += 1;
          }
          next_issue[jc] = t + rq_th[jc];
          next_idx[jc] = idx + 1;
          const int sl = idx + 1 < N - 1 ? idx + 1 : N - 1;
          rq_w[jc] = sw[c * N + sl];
          rq_b[jc] = sb[c * N + sl];
          rq_r[jc] = sr[c * N + sl];
          rq_s[jc] = ssub[c * N + sl];
          rq_th[jc] = sth[c * N + sl];
        }
        if (mine && rem == 0 && finish[jc] < 0) finish[jc] = t;
        act = act || (mine && rem > 0);
        if (NCL > 1 && ib != 0) g.sync();  // the next round reads the tails
      }
      m.wpend += n_wr;
      active = g.any(act);
      if (appended) g.sync();  // ring entries and tails visible to the banks
      t += 1;
      // the tick a cell's last core finishes, the cell deactivates: no
      // accrual, no decision and no serve (the plain version masks all
      // three for an inactive cell)
      if (!active) break;
      const int now = t - 1;

      // queue depths after this tick's appends, and the heads
      int dem[NBL];
      bool has[NBL];
#pragma unroll
      for (int j = 0; j < NBL; ++j) {
        const int b = m.bank(j);
        dem[j] = m.valid(j) ? q_tail[b] - q_head[j] : 0;
        has[j] = dem[j] > 0;
        if (has[j] && !head_ok[j]) {
          h[j] = ring_head(ring[b * LQ + (q_head[j] & QM)]);
          head_ok[j] = true;
        }
      }

      // ---- 2: write-drain watermark
      if (m.wpend >= a.d.HI) m.drain = 1;

      // ---- 3: per-rank refresh debt
      m.refresh_debt(now);

      // ---- 4: refresh decisions
      bool mid[NBL];
      m.refresh_decide(now, dem, mid);

      // ---- 5: occupancy-aware arbitration + serve, one start per channel
      // in channel order; the drain flag is snapshotted before any serve
      const bool drain_arb = m.drain != 0;
      int n_ws = 0;
      bool parked = false;  // a read's return parked: sync before phase 0
      for (int ch = 0; ch < a.d.NC; ++ch) {
        const int win = m.arbitrate(now, ch, has, h, dem, mid, drain_arb);
        if (win < 0) continue;
        int done;
        const int w = m.serve(now, ch, win, h, mid, done);
        n_ws += w;
        parked = parked || !w;
        if (g.lane == (win & (G - 1))) {
#pragma unroll
          for (int j = 0; j < NBL; ++j) {
            if (m.bank(j) != win) continue;
            q_head[j] += 1;
            const Head served = h[j];
            // the next head, if queued already
            head_ok[j] = dem[j] > 1;
            if (head_ok[j])
              h[j] = ring_head(ring[win * LQ + (q_head[j] & QM)]);
            if (!served.w) {
              // park the data return in the core's first free MLP-window
              // slot (the first slot when none is free, as the serial
              // walk's default)
              const int c = served.core;
              int* win = comp_t + c * K;
              const int k = ret_free[c] < K ? ret_free[c] : 0;
              win[k] = done;
              if (done < ret_min[c]) ret_min[c] = done;
              int next = K;
              for (int i = k + 1; i < K; ++i)
                if (win[i] == PAD_ARRIVE) {
                  next = i;
                  break;
                }
              ret_free[c] = next;
            }
          }
        }
        if (a.d.NC > 1 && !w) g.sync();  // the next channel's parking sees it
      }
      m.writes_served(n_ws);
      if (parked) g.sync();  // parked returns visible to the cores' lanes
    }

    // ---- stats, reduced in the kernel
    bool left = false;
#pragma unroll
    for (int jc = 0; jc < NCL; ++jc) {
      const int c = g.lane + G * jc;
      if (c >= C) continue;
      left = left || remaining[jc] > 0;
      a.core_finish[(size_t)cell * C + c] = finish[jc] < 0 ? t : finish[jc];
    }
    const bool finished = !g.any(left);
    m.write_stats(a.stats + (size_t)cell * MEGA_NSTAT, finished);
    if (g.lane == 0) a.ticks[cell] = t;
  }
}

// One instantiation: G lanes a cell, NBL bank slots and NCL core slots a
// lane.
template <int G, int NBL, int NCL>
struct ClosedKernel {
  static int words(int S, int C, int K) {
    return closed_cell_words(G * NBL, S, C, K);
  }
  static int plan(LaunchPlan& p, int n, int S, int C, int K, int cells) {
    p.G = G;
    p.cells = clamp_cells(cells, G, 4 * words(S, C, K));
    p.smem_bytes = 4 * words(S, C, K) * p.cells;
    return plan_blocks(sweep_mega_closed_kernel<G, NBL, NCL>, p, n);
  }
  static void launch(const LaunchPlan& p, MegaClosedArgs& a,
                     cudaStream_t st) {
    a.cell_words = words(a.d.S, a.C, a.K);
    sweep_mega_closed_kernel<G, NBL, NCL>
        <<<p.blocks, p.cells * G, p.smem_bytes, st>>>(a);
  }
};

// The instantiation a cell shape runs: G the smallest power of two that
// covers its banks and cores, at least 8; past 32 the wide ones.
template <class F>
static int closed_dispatch(int B, int C, F f) {
  if (C > 32) return f(ClosedKernel<32, SWEEP_WIDE, SWEEP_WIDE_CORES>{});
  if (B > 32) return f(ClosedKernel<32, SWEEP_WIDE, 1>{});
  const int m = B > C ? B : C;
  if (m <= 8) return f(ClosedKernel<8, 1, 1>{});
  if (m <= 16) return f(ClosedKernel<16, 1, 1>{});
  return f(ClosedKernel<32, 1, 1>{});
}

static bool closed_shape_ok(int B, int C, int NB, int NR, int NC, int LQ) {
  return B >= 1 && B <= SWEEP_MAX_BANKS && C >= 1 && C <= SWEEP_MAX_CORES &&
         B == NC * NR * NB && LQ >= 1 && (LQ & (LQ - 1)) == 0;
}

// The launch layout for n cells asking `cells` cells a block: out[0..5]
// = G, cells a block, resident blocks, shared bytes a block, registers a
// thread, local (spill) bytes a thread. The caller allocates `blocks *
// cells` group slots of ring queues and histogram.
extern "C" int sweep_mega_closed_plan(int n, int B, int S, int NB, int NR,
                                      int NC, int C, int K, int LQ,
                                      int cells, int* out) {
  if (!closed_shape_ok(B, C, NB, NR, NC, LQ) || S < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  LaunchPlan p{};
  const int err = closed_dispatch(B, C, [&](auto k) {
    return decltype(k)::plan(p, n < 1 ? 1 : n, S, C, K, cells);
  });
  out[0] = p.G;
  out[1] = p.cells;
  out[2] = p.blocks;
  out[3] = p.smem_bytes;
  out[4] = p.regs;
  out[5] = p.local_bytes;
  return err;
}

extern "C" int sweep_mega_closed_launch(
    const int* params, const int* scn_of_cell, const int* sw, const int* sb,
    const int* sr, const int* ssub, const int* sth, const int* nreq,
    int* stats, int* core_finish, int* ticks, int* ring, int* hist,
    int* next_cell, int n, int B, int S, int NB, int NR, int NC, int C,
    int N, int K, int LQ, int HI, int LO, int CAP, int cells, int slots,
    void* stream) {
  if (n == 0) return 0;
  if (!closed_shape_ok(B, C, NB, NR, NC, LQ) || S < 1 || K < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  MegaClosedArgs a;
  a.params = params;
  a.scn_of_cell = scn_of_cell;
  a.sw = sw; a.sb = sb; a.sr = sr; a.ssub = ssub; a.sth = sth;
  a.nreq = nreq;
  a.stats = stats;
  a.core_finish = core_finish;
  a.ticks = ticks;
  a.ring = (int4*)ring;
  a.hist = hist;
  a.next_cell = next_cell;
  a.n = n;
  a.d.B = B; a.d.S = S; a.d.NB = NB; a.d.NR = NR; a.d.NC = NC;
  a.d.R = NC * NR;
  a.d.HI = HI; a.d.LO = LO;
  a.C = C; a.N = N; a.K = K; a.LQ = LQ; a.CAP = CAP;
  return closed_dispatch(B, C, [&](auto k) {
    LaunchPlan p{};
    int err = decltype(k)::plan(p, n, S, C, K, cells);
    if (err != 0) return err;
    if (p.blocks * p.cells > slots) return (int)cudaErrorInvalidValue;
    decltype(k)::launch(p, a, (cudaStream_t)stream);
    return (int)cudaGetLastError();
  });
}
