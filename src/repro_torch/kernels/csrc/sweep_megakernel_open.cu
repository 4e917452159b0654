// sweep_mega_open_kernel - the whole open-loop tick loop (contract phases
// A-E) of the sweep engine, a group of G lanes per cell, run to that
// cell's completion, with the integer stats reduced in the kernel.
//
// Replaces the TPU kernel `_mega_open_kernel` / `_open_call` of the JAX
// package (repro/kernels/sweep_megakernel.py). Plain version:
// `torchbody.open_body` driven by `run_open`
// (repro_torch/core/sweep/torchbody.py), reached through `mega_open_cells`
// in repro_torch/kernels/sweep_megakernel.py.
//
// The design is the closed-loop kernel's (sweep_megakernel.cu says why a
// group of lanes per cell): lane b owns bank b, phases B-D are the group
// functions of sweep_tick.cuh, the bank state is in registers and the
// subarray planes in shared memory. What is the open loop's own is where
// requests come from: each bank replays its scenario's arrival FIFO (`qa
// qr qs qw [NS, B, L]`, `npb [NS, B]` real entries, read at
// `scn_of_cell`), and a bank's queue is the FIFO slice [n_served,
// n_arrived). Phase A walks the FIFOs in parallel, a bank a lane: several
// arrivals may share a stamp, and every arriving write counts against the
// buffer (a group sum) before the watermark test. A bank's lane keeps its
// next arrival's stamp and write flag and its queue head in registers,
// fetching the next entry of the FIFO when one arrives or is served.
//
// What bounds it: latency, as for the closed kernel. A finished cell is
// inert in the plain version's shared loop (no request left, policy
// forced to `ideal`, no debt, no all-bank start), so a group leaves a cell
// when it has served every request, and an unfinished cell runs to the
// grid's horizon, as in the shared loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_fields.h"
#include "sweep_tick.cuh"

#define SWEEP_WIDE (SWEEP_MAX_BANKS / 32)

struct MegaOpenArgs {
  const int* params;       // [n, MEGA_NPARAM]
  const int* scn_of_cell;  // [n]
  const int *qa, *qr, *qs, *qw;  // [NS, B, L] per-scenario arrival FIFOs
  const int* npb;          // [NS, B] real entries per FIFO
  int* stats;              // [n, MEGA_NSTAT]
  int* ticks;              // [n] ticks this cell ran
  int* hist;               // [slots, SWEEP_HIST_BINS], zeroed by the caller
  int* next_cell;          // one counter, zeroed by the caller
  int n;
  TickDims d;
  int L;
  int cell_words;          // shared words a cell
};

template <int G, int NBL>
__global__ void sweep_mega_open_kernel(MegaOpenArgs a) {
  extern __shared__ int sweep_smem[];
  using M = Machine<G, NBL>;
  const Group<G> g = Group<G>::here();
  const int gi = threadIdx.x / G;
  const size_t slot = (size_t)blockIdx.x * (blockDim.x / G) + gi;
  const int B = a.d.B, S = a.d.S, LF = a.L;
  int* sh = sweep_smem + gi * a.cell_words;
  M m;
  m.g = g;
  m.d = a.d;
  m.place();
  m.ref_until = sh;
  m.open_row = sh + S * M::BP;
  m.hist = a.hist + slot * SWEEP_HIST_BINS;
  const int occ[NBL] = {};  // the open form has no occupancy field

  for (;;) {
    int cell = 0;
    if (g.lane == 0) cell = atomicAdd(a.next_cell, 1);
    cell = g.bcast(cell, 0);
    if (cell >= a.n) return;
    m.P = load_params(a.params + (size_t)cell * MEGA_NPARAM);
    const int scn = a.scn_of_cell[cell];
    const size_t qoff = (size_t)scn * B * LF;
    const int* qa = a.qa + qoff;
    const int* qr = a.qr + qoff;
    const int* qs = a.qs + qoff;
    const int* qw = a.qw + qoff;

    // ---- t = 0 state. Per slot: FIFO length, arrived and served
    // counts, the next arrival (stamp, write flag; INT_MAX: none left),
    // and the head: the entry at n_served.
    m.init();
    int nb[NBL], na[NBL], ns[NBL], nx_t[NBL], nx_w[NBL];
    Head h[NBL];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < NBL; ++j) {
      const int b = m.bank(j);
      nb[j] = m.valid(j) ? a.npb[(size_t)scn * B + b] : 0;
      mine += nb[j];
      na[j] = ns[j] = 0;
      nx_t[j] = INT_MAX;
      nx_w[j] = 0;
      h[j] = Head{0, 0, 0, 0, 0};
      if (nb[j] > 0) {
        const int i = b * LF;
        nx_t[j] = qa[i];
        nx_w[j] = qw[i] != 0;
        h[j] = Head{qr[i], qs[i], qa[i], qw[i] != 0, 0};
      }
    }
    const int n_tot = g.sum(mine);
    g.sync();  // the group's shared planes are initialized

    int served = 0;
    int t = 0;
    // the cell is active while it has requests left to serve
    while (served < n_tot && t < m.P.horizon) {
      // ---- A: arrivals - every request of a bank stamped at or before t
      // joins its queue (several in one tick if they share a stamp); each
      // arriving write counts against the buffer before the watermark test
      int n_w = 0, dem[NBL];
      bool has[NBL];
#pragma unroll
      for (int j = 0; j < NBL; ++j) {
        while (nx_t[j] <= t) {
          n_w += nx_w[j];
          na[j] += 1;
          nx_t[j] = INT_MAX;
          if (na[j] < nb[j]) {
            const int i = m.bank(j) * LF + na[j];
            nx_t[j] = qa[i];
            nx_w[j] = qw[i] != 0;
          }
        }
        dem[j] = na[j] - ns[j];
        has[j] = dem[j] > 0;
      }
      m.wpend += g.sum(n_w);
      if (m.wpend >= a.d.HI) m.drain = 1;

      // ---- B: per-rank refresh debt
      m.refresh_debt(t);

      // ---- C: refresh decisions (queue depth after this tick's arrivals)
      bool mid[NBL];
      m.refresh_decide(t, dem, mid);

      // ---- D: arbitration + serve, one start per channel in channel
      // order; the drain flag is snapshotted before any serve
      const bool drain_arb = m.drain != 0;
      int n_ws = 0;
      for (int ch = 0; ch < a.d.NC; ++ch) {
        const int win = m.arbitrate(t, ch, has, h, occ, mid, drain_arb);
        if (win < 0) continue;
        int done;
        n_ws += m.serve(t, ch, win, h, mid, done);
        served += 1;
        if (g.lane == (win & (G - 1))) {
#pragma unroll
          for (int j = 0; j < NBL; ++j) {
            if (m.bank(j) != win) continue;
            ns[j] += 1;
            if (ns[j] < nb[j]) {
              const int i = win * LF + ns[j];
              h[j] = Head{qr[i], qs[i], qa[i], qw[i] != 0, 0};
            }
          }
        }
      }
      m.writes_served(n_ws);
      t += 1;
    }

    // ---- stats, reduced in the kernel
    m.write_stats(a.stats + (size_t)cell * MEGA_NSTAT, served >= n_tot);
    if (g.lane == 0) a.ticks[cell] = t;
  }
}

// One instantiation: G lanes a cell, NBL bank slots a lane.
template <int G, int NBL>
struct OpenKernel {
  static int words(int S) { return 2 * S * G * NBL; }
  static int plan(LaunchPlan& p, int n, int S, int cells) {
    p.G = G;
    p.cells = clamp_cells(cells, G, 4 * words(S));
    p.smem_bytes = 4 * words(S) * p.cells;
    return plan_blocks(sweep_mega_open_kernel<G, NBL>, p, n);
  }
  static void launch(const LaunchPlan& p, MegaOpenArgs& a, cudaStream_t st) {
    a.cell_words = words(a.d.S);
    sweep_mega_open_kernel<G, NBL>
        <<<p.blocks, p.cells * G, p.smem_bytes, st>>>(a);
  }
};

// The instantiation a cell shape runs: G the smallest power of two that
// covers its banks, at least 8; past 32 banks the wide one.
template <class F>
static int open_dispatch(int B, F f) {
  if (B > 32) return f(OpenKernel<32, SWEEP_WIDE>{});
  if (B <= 8) return f(OpenKernel<8, 1>{});
  if (B <= 16) return f(OpenKernel<16, 1>{});
  return f(OpenKernel<32, 1>{});
}

static bool open_shape_ok(int B, int S, int NB, int NR, int NC, int L) {
  return B >= 1 && B <= SWEEP_MAX_BANKS && B == NC * NR * NB && S >= 1 &&
         L >= 1;
}

// The launch layout for n cells asking `cells` cells a block, as
// `sweep_mega_closed_plan` gives it; the caller allocates `blocks *
// cells` group slots of histogram.
extern "C" int sweep_mega_open_plan(int n, int B, int S, int NB, int NR,
                                    int NC, int L, int cells, int* out) {
  if (!open_shape_ok(B, S, NB, NR, NC, L)) return (int)cudaErrorInvalidValue;
  LaunchPlan p{};
  const int err = open_dispatch(B, [&](auto k) {
    return decltype(k)::plan(p, n < 1 ? 1 : n, S, cells);
  });
  out[0] = p.G;
  out[1] = p.cells;
  out[2] = p.blocks;
  out[3] = p.smem_bytes;
  out[4] = p.regs;
  out[5] = p.local_bytes;
  return err;
}

extern "C" int sweep_mega_open_launch(
    const int* params, const int* scn_of_cell, const int* qa, const int* qr,
    const int* qs, const int* qw, const int* npb, int* stats, int* ticks,
    int* hist, int* next_cell, int n, int B, int S, int NB, int NR, int NC,
    int L, int HI, int LO, int cells, int slots, void* stream) {
  if (n == 0) return 0;
  if (!open_shape_ok(B, S, NB, NR, NC, L)) return (int)cudaErrorInvalidValue;
  MegaOpenArgs a;
  a.params = params;
  a.scn_of_cell = scn_of_cell;
  a.qa = qa; a.qr = qr; a.qs = qs; a.qw = qw;
  a.npb = npb;
  a.stats = stats;
  a.ticks = ticks;
  a.hist = hist;
  a.next_cell = next_cell;
  a.n = n;
  a.d.B = B; a.d.S = S; a.d.NB = NB; a.d.NR = NR; a.d.NC = NC;
  a.d.R = NC * NR;
  a.d.HI = HI; a.d.LO = LO;
  a.L = L;
  return open_dispatch(B, [&](auto k) {
    LaunchPlan p{};
    int err = decltype(k)::plan(p, n, S, cells);
    if (err != 0) return err;
    if (p.blocks * p.cells > slots) return (int)cudaErrorInvalidValue;
    decltype(k)::launch(p, a, (cudaStream_t)stream);
    return (int)cudaGetLastError();
  });
}
