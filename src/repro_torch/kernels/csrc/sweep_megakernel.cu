// sweep_mega_closed_kernel - the whole closed-loop tick loop (contract
// phases 0-5) of the sweep engine, one cell per thread, run to that
// cell's completion, with the integer stats reduced in the kernel.
//
// Replaces the TPU kernel `_mega_closed_kernel` / `_closed_call` of the
// JAX package (repro/kernels/sweep_megakernel.py). Plain version:
// `torchbody.closed_body` driven by `run_closed`
// (repro_torch/core/sweep/torchbody.py), reached through
// `mega_closed_cells` in repro_torch/kernels/sweep_megakernel.py.
//
// Why one cell per thread. On the TPU a tile of cells shares one
// `while_loop` and scenario-pure tiles exist to gather one stream plane
// per tile. Here cells are independent: each thread reads its scenario's
// streams at offset `scn_of_cell[g]`, loops `while t < horizon && any
// core has requests left` and exits alone; a finished cell is inert in
// the shared loop of the plain version, so the two agree bit for bit.
// The loop is a serial chain of small data-dependent integer steps with
// scatters into per-cell queues - no reuse across cells and no matrix
// work - so the card is used by running many cells at once, not by
// splitting one: a grid has 10^3..10^5 cells, enough to fill every SM
// with one cell per lane, while one warp per cell would leave most lanes
// idle in the phases that touch one bank or one core. The wrapper picks
// the block size from the cell count: a small grid gets small blocks, so
// that its few cells spread over the SMs and their caches.
//
// What bounds it: latency, not bytes or arithmetic. Inputs and outputs
// are a few hundred bytes a cell; the time goes into the dependent chain
// of loads and stores on the cell's own state, tick after tick. The
// design keeps what it can in registers (counters, masks of banks) and
// lays the rest out [word][cell] in a global scratch plane, so the lanes
// of a warp - neighbouring cells, sorted by the host to share scenario,
// density and policy - touch the same words in the same lines while they
// run in step. The ring queues (5 * B * LQ words) and the 4096-bin
// latency histogram are per cell and too big for shared memory; they
// live in scratch the wrapper allocates (the histogram zeroed). Cells of
// more than 64 banks run the wide instantiation (sweep_tick.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_fields.h"
#include "sweep_tick.cuh"

// Word offsets of one cell's closed-loop state in the scratch plane.
struct ClosedLayout {
  MachineLayout m;
  int q_head, q_tail;                                  // [B]
  int next_idx, next_issue, out_reads, remaining, finish;  // [C]
  int comp_t;                                          // [C * K]
  int qa, qr, qs, qw, qc;                              // [B * LQ]
  int words;
};

__host__ __device__ inline ClosedLayout closed_layout(int B, int S, int NC,
                                                      int R, int C, int K,
                                                      int LQ) {
  ClosedLayout L;
  int w = 0;
  L.m.bank_free = w; w += B;
  L.m.ref_until = w; w += B * S;
  L.m.open_row = w; w += B * S;
  L.m.open_sub = w; w += B;
  L.m.ctr = w; w += B;
  L.m.issued = w; w += B;
  L.m.last_op = w; w += NC;
  L.m.last_rank = w; w += NC;
  L.m.ab_pending = w; w += R;
  L.m.rank_drain = w; w += R;
  L.q_head = w; w += B;
  L.q_tail = w; w += B;
  L.next_idx = w; w += C;
  L.next_issue = w; w += C;
  L.out_reads = w; w += C;
  L.remaining = w; w += C;
  L.finish = w; w += C;
  L.comp_t = w; w += C * K;
  L.qa = w; w += B * LQ;
  L.qr = w; w += B * LQ;
  L.qs = w; w += B * LQ;
  L.qw = w; w += B * LQ;
  L.qc = w; w += B * LQ;
  L.words = w;
  return L;
}

struct MegaClosedArgs {
  const int* params;       // [n, MEGA_NPARAM]
  const int* scn_of_cell;  // [n]
  const int *sw, *sb, *sr, *ssub, *sth;  // [NS, C, N] per-scenario streams
  const int* nreq;         // [NS, C]
  int* stats;              // [n, MEGA_NSTAT]
  int* core_finish;        // [n, C]
  int* ticks;              // [n] ticks this cell ran
  int* scratch;            // [words, n]
  int* hist;               // [MAX_LAT_TICKS + 1, n], zeroed by the caller
  int n;
  TickDims d;
  int C, N, K, LQ, CAP;
};

// Heads of the closed-loop ring bank queues.
struct RingHeads {
  const Cell& st;
  const ClosedLayout& L;
  const int* dem;
  int LQ;
  __device__ __forceinline__ bool has(int b) const { return dem[b] > 0; }
  __device__ __forceinline__ Head get(int b) const {
    int slot = b * LQ + (st(L.q_head + b) & (LQ - 1));
    Head h;
    h.row = st(L.qr + slot);
    h.sub = st(L.qs + slot);
    h.arrive = st(L.qa + slot);
    h.is_write = st(L.qw + slot);
    return h;
  }
};

template <int W>
__global__ void sweep_mega_closed_kernel(MegaClosedArgs a) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= a.n) return;
  const TickDims d = a.d;
  const int B = d.B, C = a.C, N = a.N, K = a.K, LQ = a.LQ, QM = a.LQ - 1;
  const CellParams P = load_params(a.params + (size_t)g * MEGA_NPARAM);
  const ClosedLayout L = closed_layout(B, d.S, d.NC, d.R, C, K, LQ);
  const Cell st{a.scratch + g, (size_t)a.n};
  int* hist = a.hist + g;
  const size_t hs = (size_t)a.n;

  const size_t soff = (size_t)a.scn_of_cell[g] * C * N;
  const int* sw = a.sw + soff;
  const int* sb = a.sb + soff;
  const int* sr = a.sr + soff;
  const int* ssub = a.ssub + soff;
  const int* sth = a.sth + soff;
  const int* nreq = a.nreq + (size_t)a.scn_of_cell[g] * C;

  // ---- t = 0 state
  machine_init(d, L.m, st);
  for (int b = 0; b < B; ++b) {
    st(L.q_head + b) = 0;
    st(L.q_tail + b) = 0;
  }
  bool active = false;
  for (int c = 0; c < C; ++c) {
    int n_req = nreq[c];
    st(L.next_idx + c) = 0;
    st(L.next_issue + c) = 0;
    st(L.out_reads + c) = 0;
    st(L.remaining + c) = n_req;
    st(L.finish + c) = n_req == 0 ? 0 : -1;
    active = active || n_req > 0;
    for (int k = 0; k < K; ++k) st(L.comp_t + c * K + k) = PAD_ARRIVE;
  }
  Counters cn;
  cn.rr = cn.ab_rr = cn.wpend = cn.drain = 0;
  cn.reads = cn.writes = cn.hits = cn.misses = 0;
  cn.refpb = cn.refab = cn.lat_sum = cn.maxlag = cn.last_done = 0;

  int dem[64 * W];
  int t = 0;
  while (active && t < P.horizon) {
    // ---- 0: outstanding-read completions
    for (int c = 0; c < C; ++c) {
      int n_exp = 0;
      for (int k = 0; k < K; ++k) {
        if (st(L.comp_t + c * K + k) <= t) {
          st(L.comp_t + c * K + k) = PAD_ARRIVE;
          n_exp += 1;
        }
      }
      if (n_exp) {
        st(L.out_reads + c) -= n_exp;
        st(L.remaining + c) -= n_exp;
      }
    }

    // ---- 1: core issue, at most one per core per tick, in core order
    // (two cores that target one bank take consecutive ring slots in
    // core order; writes queue first-come against the buffer space left
    // at the start of the tick)
    const int wroom = a.CAP - cn.wpend;
    int writers = 0;
    active = false;
    for (int c = 0; c < C; ++c) {
      int idx = st(L.next_idx + c);
      int n_req = nreq[c];
      int rem = st(L.remaining + c);
      if (idx < n_req && st(L.next_issue + c) <= t) {
        int sl = idx < N - 1 ? idx : N - 1;
        bool head_w = sw[c * N + sl] != 0;
        bool issue;
        if (head_w) {
          issue = writers < wroom;
          writers += 1;
        } else {
          issue = st(L.out_reads + c) < P.mlp;
        }
        if (issue) {
          int hb = sb[c * N + sl];
          int tail = st(L.q_tail + hb);
          int slot = hb * LQ + (tail & QM);
          st(L.qa + slot) = t;
          st(L.qr + slot) = sr[c * N + sl];
          st(L.qs + slot) = ssub[c * N + sl];
          st(L.qw + slot) = head_w ? 1 : 0;
          st(L.qc + slot) = c;
          st(L.q_tail + hb) = tail + 1;
          if (head_w) {
            cn.wpend += 1;
            rem -= 1;  // writes retire at issue
            st(L.remaining + c) = rem;
          } else {
            st(L.out_reads + c) += 1;
          }
          st(L.next_issue + c) = t + sth[c * N + sl];
          st(L.next_idx + c) = idx + 1;
        }
      }
      if (rem == 0 && st(L.finish + c) < 0) st(L.finish + c) = t;
      active = active || rem > 0;
    }
    t += 1;
    // the tick a cell's last core finishes, the cell deactivates: no
    // accrual, no decision and no serve (the plain version masks all
    // three for an inactive cell)
    if (!active) break;
    const int now = t - 1;

    // ---- 2: write-drain watermark
    if (cn.wpend >= d.HI) cn.drain = 1;

    // ---- 3: per-rank refresh debt
    refresh_debt(d, P, L.m, st, now);

    // ---- 4: refresh decisions (queue depth after this tick's appends)
    for (int b = 0; b < B; ++b)
      dem[b] = st(L.q_tail + b) - st(L.q_head + b);
    const BankSet<W> mid = refresh_decide<W>(d, P, L.m, st, now, dem, cn);

    // ---- 5: occupancy-aware arbitration + serve, one start per channel
    // in channel order; the drain flag is snapshotted before any serve
    const bool drain_arb = cn.drain != 0;
    const RingHeads heads{st, L, dem, LQ};
    for (int ch = 0; ch < d.NC; ++ch) {
      Head h;
      int b = arbitrate_channel(d, L.m, st, now, ch, heads, dem, mid,
                                drain_arb, h);
      if (b < 0) continue;
      int slot = b * LQ + (st(L.q_head + b) & QM);
      int core = st(L.qc + slot);
      int done = serve_bank(d, P, L.m, st, hist, hs, now, ch, b, h, mid, cn);
      st(L.q_head + b) += 1;
      if (!h.is_write) {
        // park the data return in the core's first free MLP-window slot
        int free_k = 0;
        for (int k = 0; k < K; ++k) {
          if (st(L.comp_t + core * K + k) == PAD_ARRIVE) {
            free_k = k;
            break;
          }
        }
        st(L.comp_t + core * K + free_k) = done;
      }
    }
  }

  // ---- stats, reduced in the kernel
  bool finished = true;
  for (int c = 0; c < C; ++c) {
    finished = finished && st(L.remaining + c) <= 0;
    int f = st(L.finish + c);
    a.core_finish[(size_t)g * C + c] = f < 0 ? t : f;
  }
  int* out = a.stats + (size_t)g * MEGA_NSTAT;
  out[MS_READS] = cn.reads;
  out[MS_WRITES] = cn.writes;
  out[MS_HITS] = cn.hits;
  out[MS_MISSES] = cn.misses;
  out[MS_REFPB] = cn.refpb;
  out[MS_REFAB] = cn.refab;
  out[MS_LATSUM] = cn.lat_sum;
  out[MS_MAXLAG] = cn.maxlag;
  out[MS_LASTDONE] = cn.last_done;
  out[MS_P99] = p99_from_hist(hist, hs, cn.reads);
  out[MS_FINISHED] = finished ? 1 : 0;
  a.ticks[g] = t;
}

extern "C" long long sweep_mega_closed_scratch_words(int B, int S, int NC,
                                                     int R, int C, int K,
                                                     int LQ) {
  return closed_layout(B, S, NC, R, C, K, LQ).words;
}

extern "C" int sweep_mega_closed_launch(
    const int* params, const int* scn_of_cell, const int* sw, const int* sb,
    const int* sr, const int* ssub, const int* sth, const int* nreq,
    int* stats, int* core_finish, int* ticks, int* scratch, int* hist,
    int n, int B, int S, int NB, int NR, int NC, int C, int N, int K,
    int LQ, int HI, int LO, int CAP, int threads, void* stream) {
  if (n == 0) return 0;
  if (B > SWEEP_MAX_BANKS || B != NC * NR * NB || (LQ & (LQ - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  MegaClosedArgs a;
  a.params = params;
  a.scn_of_cell = scn_of_cell;
  a.sw = sw; a.sb = sb; a.sr = sr; a.ssub = ssub; a.sth = sth;
  a.nreq = nreq;
  a.stats = stats;
  a.core_finish = core_finish;
  a.ticks = ticks;
  a.scratch = scratch;
  a.hist = hist;
  a.n = n;
  a.d.B = B; a.d.S = S; a.d.NB = NB; a.d.NR = NR; a.d.NC = NC;
  a.d.R = NC * NR;
  a.d.HI = HI; a.d.LO = LO;
  a.C = C; a.N = N; a.K = K; a.LQ = LQ; a.CAP = CAP;
  int blocks = (n + threads - 1) / threads;
  if (B <= 64)
    sweep_mega_closed_kernel<1>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  else
    sweep_mega_closed_kernel<SWEEP_WIDE_WORDS>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
