// sweep_mega_open_kernel - the whole open-loop tick loop (contract phases
// A-E) of the sweep engine, one cell per thread, run to that cell's
// completion, with the integer stats reduced in the kernel.
//
// Replaces the TPU kernel `_mega_open_kernel` / `_open_call` of the JAX
// package (repro/kernels/sweep_megakernel.py). Plain version:
// `torchbody.open_body` driven by `run_open`
// (repro_torch/core/sweep/torchbody.py), reached through `mega_open_cells`
// in repro_torch/kernels/sweep_megakernel.py.
//
// The design is the closed-loop kernel's (sweep_megakernel.cu says why
// one cell per thread): the cell's machine state lives [word][cell] in a
// global scratch plane, counters and bank sets in registers, and phases
// B-D are the `__device__` functions of sweep_tick.cuh. What is the open
// loop's own is where requests come from: each bank replays its
// scenario's arrival FIFO (`qa qr qs qw [NS, B, L]`, `npb [NS, B]` real
// entries, read at `scn_of_cell[g]`), and a bank's queue is the FIFO
// slice [n_served, n_arrived). So the reference's mirrors - next arrival,
// next write flag and the head planes - are not state here: each is the
// FIFO entry at n_arrived or n_served, read when needed. The per-cell
// state is 2*B*S + 6*B + 2*NC + 2*R words plus the 4096-bin histogram.
//
// What bounds it: latency, as for the closed kernel - a serial chain of
// small dependent steps on the cell's own state, tick after tick. A
// finished cell is inert in the plain version's shared loop (no request
// left, policy forced to `ideal`, no debt, no all-bank start), so a
// thread exits alone when its cell has served every request, and an
// unfinished cell runs to the grid's horizon, as in the shared loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_fields.h"
#include "sweep_tick.cuh"

// Word offsets of one cell's open-loop state in the scratch plane.
struct OpenLayout {
  MachineLayout m;
  int n_arrived, n_served;  // [B]
  int words;
};

__host__ __device__ inline OpenLayout open_layout(int B, int S, int NC,
                                                  int R) {
  OpenLayout L;
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
  L.n_arrived = w; w += B;
  L.n_served = w; w += B;
  L.words = w;
  return L;
}

struct MegaOpenArgs {
  const int* params;       // [n, MEGA_NPARAM]
  const int* scn_of_cell;  // [n]
  const int *qa, *qr, *qs, *qw;  // [NS, B, L] per-scenario arrival FIFOs
  const int* npb;          // [NS, B] real entries per FIFO
  int* stats;              // [n, MEGA_NSTAT]
  int* ticks;              // [n] ticks this cell ran
  int* scratch;            // [words, n]
  int* hist;               // [MAX_LAT_TICKS + 1, n], zeroed by the caller
  int n;
  TickDims d;
  int L;
};

// Heads of the open-loop bank queues: bank b's head is its FIFO entry at
// n_served[b]; `dem[b]` = n_arrived[b] - n_served[b] as of phase C.
struct ArrivalHeads {
  const Cell& st;
  const OpenLayout& L;
  const int* dem;
  const int *qa, *qr, *qs, *qw;
  int LF;
  __device__ __forceinline__ bool has(int b) const { return dem[b] > 0; }
  __device__ __forceinline__ Head get(int b) const {
    int i = b * LF + st(L.n_served + b);
    Head h;
    h.row = qr[i];
    h.sub = qs[i];
    h.arrive = qa[i];
    h.is_write = qw[i];
    return h;
  }
};

template <int W>
__global__ void sweep_mega_open_kernel(MegaOpenArgs a) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= a.n) return;
  const TickDims d = a.d;
  const int B = d.B, LF = a.L;
  const CellParams P = load_params(a.params + (size_t)g * MEGA_NPARAM);
  const OpenLayout L = open_layout(B, d.S, d.NC, d.R);
  const Cell st{a.scratch + g, (size_t)a.n};
  int* hist = a.hist + g;
  const size_t hs = (size_t)a.n;

  const int scn = a.scn_of_cell[g];
  const size_t qoff = (size_t)scn * B * LF;
  const int* qa = a.qa + qoff;
  const int* qr = a.qr + qoff;
  const int* qs = a.qs + qoff;
  const int* qw = a.qw + qoff;
  const int* npb = a.npb + (size_t)scn * B;

  // ---- t = 0 state
  machine_init(d, L.m, st);
  int n_tot = 0;
  for (int b = 0; b < B; ++b) {
    st(L.n_arrived + b) = 0;
    st(L.n_served + b) = 0;
    n_tot += npb[b];
  }
  Counters cn;
  cn.rr = cn.ab_rr = cn.wpend = cn.drain = 0;
  cn.reads = cn.writes = cn.hits = cn.misses = 0;
  cn.refpb = cn.refab = cn.lat_sum = cn.maxlag = cn.last_done = 0;

  int dem[64 * W];
  int served = 0;
  int t = 0;
  // the cell is active while it has requests left to serve
  while (served < n_tot && t < P.horizon) {
    // ---- A: arrivals - every request of a bank stamped at or before t
    // joins its queue (several in one tick if they share a stamp); each
    // arriving write counts against the buffer before the watermark test
    for (int b = 0; b < B; ++b) {
      const int* fa = qa + (size_t)b * LF;
      const int* fw = qw + (size_t)b * LF;
      int na = st(L.n_arrived + b);
      const int nb = npb[b];
      while (na < nb && fa[na] <= t) {
        if (fw[na]) cn.wpend += 1;
        na += 1;
      }
      st(L.n_arrived + b) = na;
      dem[b] = na - st(L.n_served + b);
    }
    if (cn.wpend >= d.HI) cn.drain = 1;

    // ---- B: per-rank refresh debt
    refresh_debt(d, P, L.m, st, t);

    // ---- C: refresh decisions (queue depth after this tick's arrivals)
    const BankSet<W> mid = refresh_decide<W>(d, P, L.m, st, t, dem, cn);

    // ---- D: arbitration + serve, one start per channel in channel
    // order; the drain flag is snapshotted before any serve, and the open
    // form has no occupancy field
    const bool drain_arb = cn.drain != 0;
    const ArrivalHeads heads{st, L, dem, qa, qr, qs, qw, LF};
    for (int ch = 0; ch < d.NC; ++ch) {
      Head h;
      int b = arbitrate_channel(d, L.m, st, t, ch, heads, nullptr, mid,
                                drain_arb, h);
      if (b < 0) continue;
      serve_bank(d, P, L.m, st, hist, hs, t, ch, b, h, mid, cn);
      st(L.n_served + b) += 1;
      served += 1;
    }
    t += 1;
  }

  // ---- stats, reduced in the kernel
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
  out[MS_FINISHED] = served >= n_tot ? 1 : 0;
  a.ticks[g] = t;
}

extern "C" long long sweep_mega_open_scratch_words(int B, int S, int NC,
                                                   int R) {
  return open_layout(B, S, NC, R).words;
}

extern "C" int sweep_mega_open_launch(
    const int* params, const int* scn_of_cell, const int* qa, const int* qr,
    const int* qs, const int* qw, const int* npb, int* stats, int* ticks,
    int* scratch, int* hist, int n, int B, int S, int NB, int NR, int NC,
    int L, int HI, int LO, int threads, void* stream) {
  if (n == 0) return 0;
  if (B > SWEEP_MAX_BANKS || B != NC * NR * NB || L < 1)
    return (int)cudaErrorInvalidValue;
  MegaOpenArgs a;
  a.params = params;
  a.scn_of_cell = scn_of_cell;
  a.qa = qa; a.qr = qr; a.qs = qs; a.qw = qw;
  a.npb = npb;
  a.stats = stats;
  a.ticks = ticks;
  a.scratch = scratch;
  a.hist = hist;
  a.n = n;
  a.d.B = B; a.d.S = S; a.d.NB = NB; a.d.NR = NR; a.d.NC = NC;
  a.d.R = NC * NR;
  a.d.HI = HI; a.d.LO = LO;
  a.L = L;
  int blocks = (n + threads - 1) / threads;
  if (B <= 64)
    sweep_mega_open_kernel<1>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  else
    sweep_mega_open_kernel<SWEEP_WIDE_WORDS>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
