// Tick-contract phases shared by the tick-loop megakernels: refresh debt
// (phase 3 / B), the policy decisions of every vectorized policy kind
// with SARP/HiRA subarray marking (phase 4 / C), and the packed-score
// arbitration and serve of one channel (phase 5 / D). The closed-loop
// kernel drives them from ring bank queues; an open-loop kernel can drive
// the same functions from its arrival FIFOs through another `Heads` type.
//
// The definitions these functions restate, line for line, are
// `select_batch_torch` (repro_torch/core/sweep/policies.py) and
// `closed_body` (repro_torch/core/sweep/torchbody.py). All arithmetic is
// int32; every scan over banks runs lowest index first and replaces its
// best only on a strictly greater key, so ties break toward the lowest
// bank exactly like a first-maximum argmax. Every `/` and `%` has a
// non-negative left operand, guarded ahead of the division.
#pragma once
#include <stdint.h>

#include "sweep_fields.h"
#include "sweep_score.cuh"

// Banks per cell are tracked in 64-bit masks and two per-thread arrays.
#define SWEEP_MAX_BANKS 64

struct TickDims {
  int B, S, NB, NR, NC, R;  // banks, subarrays/bank, banks/rank,
                            // ranks/channel, channels, global ranks
  int HI, LO;               // write-drain watermarks
};

// One cell's constants: a row of the [n, MEGA_NPARAM] params block
// (MP_PAD is not read: this port launches no pad rows).
struct CellParams {
  int kind, level_ab, sarp, hra, wrp, urgent, budget;
  int REFI, REFI_PB, RFC_PB, RFC_AB, HIT, MISS, WR, TURN, RTR, SARP_PEN;
  int mlp, horizon;
};

__device__ __forceinline__ CellParams load_params(const int* p) {
  CellParams c;
  c.kind = p[MP_KIND];
  c.level_ab = p[MP_LEVEL_AB];
  c.sarp = p[MP_SARP];
  c.hra = p[MP_HRA];
  c.wrp = p[MP_WRP];
  c.urgent = p[MP_URGENT];
  c.budget = p[MP_BUDGET];
  c.REFI = p[MP_REFI];
  c.REFI_PB = p[MP_REFI_PB];
  c.RFC_PB = p[MP_RFC_PB];
  c.RFC_AB = p[MP_RFC_AB];
  c.HIT = p[MP_HIT];
  c.MISS = p[MP_MISS];
  c.WR = p[MP_WR];
  c.TURN = p[MP_TURN];
  c.RTR = p[MP_RTR];
  c.SARP_PEN = p[MP_SARP_PEN];
  c.mlp = p[MP_MLP];
  c.horizon = p[MP_HORIZON];
  return c;
}

// A cell's state words live in a global scratch plane laid out
// [word][cell]: word w of this cell is p[w * n]. Neighbouring threads
// (cells) touching the same word therefore share cache lines.
struct Cell {
  int* p;
  size_t n;
  __device__ __forceinline__ int& operator()(int w) const {
    return p[(size_t)w * n];
  }
};

// Word offsets of the machine-state planes inside a cell's scratch.
struct MachineLayout {
  int bank_free;    // [B]
  int ref_until;    // [B * S]
  int open_row;     // [B * S]
  int open_sub;     // [B]
  int ctr;          // [B]
  int issued;       // [B]
  int last_op;      // [NC]
  int last_rank;    // [NC]
  int ab_pending;   // [R]
  int rank_drain;   // [R]
};

// Scalars of a cell that stay in registers for the whole loop.
struct Counters {
  int rr, ab_rr, wpend, drain;
  int reads, writes, hits, misses, refpb, refab, lat_sum, maxlag,
      last_done;
};

__device__ __forceinline__ void machine_init(const TickDims& d,
                                             const MachineLayout& L,
                                             const Cell& st) {
  for (int b = 0; b < d.B; ++b) {
    st(L.bank_free + b) = 0;
    st(L.open_sub + b) = -1;
    st(L.ctr + b) = 0;
    st(L.issued + b) = 0;
  }
  for (int i = 0; i < d.B * d.S; ++i) {
    st(L.ref_until + i) = 0;
    st(L.open_row + i) = -1;
  }
  for (int c = 0; c < d.NC; ++c) {
    st(L.last_op + c) = 0;
    st(L.last_rank + c) = -1;
  }
  for (int r = 0; r < d.R; ++r) {
    st(L.ab_pending + r) = 0;
    st(L.rank_drain + r) = 0;
  }
}

// ---- phase 3: per-rank all-bank refresh debt, rank r staggered
// r * (tREFI / R) after rank 0 (active cells of level-'ab' policies)
__device__ __forceinline__ void refresh_debt(const TickDims& d,
                                             const CellParams& P,
                                             const MachineLayout& L,
                                             const Cell& st, int t) {
  if (!P.level_ab) return;
  int step = P.REFI / d.R;
  for (int r = 0; r < d.R; ++r) {
    int rp = r * step;
    if (t > rp && (t - rp) % P.REFI == 0) {
      st(L.ab_pending + r) += 1;
      st(L.rank_drain + r) = 1;
    }
  }
}

// One pick: the candidate with the largest key, lowest bank on ties.
#define SWEEP_PICK_BEST(cand_expr, key_expr)            \
  do {                                                  \
    int best_ = -1, best_key_ = 0;                      \
    for (int b = 0; b < B; ++b) {                       \
      if (!(cand_expr)) continue;                       \
      int k_ = (key_expr);                              \
      if (best_ < 0 || k_ > best_key_) {                \
        best_ = b;                                      \
        best_key_ = k_;                                 \
      }                                                 \
    }                                                   \
    if (best_ >= 0) picks |= 1ull << best_;             \
  } while (0)

// ---- phase 4a: the vectorized per-bank policy families
// (`select_batch`): returns the pick mask and advances the round-robin
// pointer. `lag`/`dem` are per-bank arrays, `ready`/`idle` bank masks.
__device__ __forceinline__ uint64_t policy_select(
    const TickDims& d, const CellParams& P, const int* lag, uint64_t ready,
    uint64_t idle, const int* dem, bool ww, int& rr) {
  const int B = d.B, kind = P.kind, bud = P.budget;
  if (kind < KIND_RR || kind >= KIND_CUSTOM) return 0;
#define RDY(b) ((ready >> (b)) & 1ull)
#define IDL(b) ((idle >> (b)) & 1ull)
  // forced sweep: every bank at the postpone edge refreshes now, and any
  // forced pick exhausts the regular allowance (max_issues == 1)
  uint64_t picks = 0;
  for (int b = 0; b < B; ++b)
    if (lag[b] >= bud && RDY(b)) picks |= 1ull << b;
  if (picks) return picks;

  if (kind == KIND_RR) {
    int idx = rr % B;
    if (lag[idx] > 0 && RDY(idx)) {
      picks = 1ull << idx;
      rr += 1;
    }
  } else if (kind == KIND_DARP) {
    bool pull = ww && P.wrp;
    SWEEP_PICK_BEST(RDY(b) && IDL(b) && dem[b] == 0 &&
                        (pull ? lag[b] > -bud : lag[b] > 0),
                    lag[b]);
  } else if (kind == KIND_RDARP) {
    bool pull = ww && P.wrp;
    uint64_t rank_idle = 0;  // per bank: its rank has no demand at all
    for (int r = 0; r < B / d.NB; ++r) {
      int sum = 0;
      for (int b = r * d.NB; b < (r + 1) * d.NB; ++b) sum += dem[b];
      if (sum == 0)
        for (int b = r * d.NB; b < (r + 1) * d.NB; ++b)
          rank_idle |= 1ull << b;
    }
    SWEEP_PICK_BEST(RDY(b) && IDL(b) && dem[b] == 0 &&
                        (pull ? lag[b] > -bud : lag[b] > 0),
                    (int)((rank_idle >> b) & 1ull) * POLICY_KD +
                        (lag[b] + bud));
  } else if (kind == KIND_ELASTIC) {
    int pressure = 0;
    for (int b = 0; b < B; ++b) pressure += dem[b];
    if (pressure == 0) {
      SWEEP_PICK_BEST(RDY(b) && IDL(b) && lag[b] > -bud, lag[b]);
    } else if (pressure <= B) {
      SWEEP_PICK_BEST(RDY(b) && IDL(b) && dem[b] == 0 && lag[b] > 0,
                      lag[b]);
    } else {
      SWEEP_PICK_BEST(RDY(b) && lag[b] >= P.urgent, lag[b]);
    }
  } else if (kind == KIND_HIRA) {
    // behind-access first, idle fallback, write-window pull-in last
    SWEEP_PICK_BEST(RDY(b) && lag[b] > 0 && dem[b] > 0,
                    dem[b] * POLICY_KD + (lag[b] + bud));
    if (!picks)
      SWEEP_PICK_BEST(RDY(b) && IDL(b) && lag[b] > 0 && dem[b] == 0,
                      lag[b]);
    if (!picks && ww) {
      // reached only when neither a hot nor a cold candidate exists
      SWEEP_PICK_BEST(RDY(b) && lag[b] > -bud,
                      dem[b] * POLICY_KD + (lag[b] + bud));
    }
  }
#undef RDY
#undef IDL
  return picks;
}

// ---- phase 4: refresh decisions of an ACTIVE cell at tick t.
// `dem[b]` is the bank's queue depth. Applies all-bank starts (ref_ab,
// staggered_ab) and per-bank picks with SARP/HiRA subarray marking, and
// returns the mask of banks with any subarray mid-refresh AFTER the
// marks (the arbitration step's `bank_mid_ref`).
__device__ __forceinline__ uint64_t refresh_decide(
    const TickDims& d, const CellParams& P, const MachineLayout& L,
    const Cell& st, int t, const int* dem, Counters& c) {
  const int B = d.B, S = d.S, NB = d.NB;
  int lag[SWEEP_MAX_BANKS];
  uint64_t ready = 0, idle = 0;
  for (int b = 0; b < B; ++b) {
    int phase = b * P.REFI_PB;
    int due = t >= phase ? (t - phase) / P.REFI + 1 : 0;
    lag[b] = due - st(L.issued + b);
    bool rdy = true;
    for (int s = 0; s < S; ++s) rdy = rdy && st(L.ref_until + b * S + s) <= t;
    if (rdy) ready |= 1ull << b;
    if (st(L.bank_free + b) <= t) idle |= 1ull << b;
  }
  uint64_t picks =
      policy_select(d, P, lag, ready, idle, dem, c.drain != 0, c.rr);

  // all-bank starts: ref_ab starts every quiet rank that owes a refresh;
  // staggered_ab walks the ranks round-robin and also needs the whole
  // channel free of refreshes
  uint64_t start_ab = 0;
  if (P.kind == KIND_AB || P.kind == KIND_STAG) {
    uint64_t quiet = 0;
    for (int r = 0; r < d.R; ++r) {
      uint64_t m = ((NB >= 64) ? ~0ull : ((1ull << NB) - 1)) << (r * NB);
      if ((idle & m) == m && (ready & m) == m) quiet |= 1ull << r;
    }
    if (P.kind == KIND_AB) {
      for (int r = 0; r < d.R; ++r)
        if (st(L.ab_pending + r) > 0 && ((quiet >> r) & 1ull))
          start_ab |= 1ull << r;
    } else {
      int idx = c.ab_rr % d.R;
      int RBC = d.NR * NB;
      int ch = idx / d.NR;
      uint64_t m = ((RBC >= 64) ? ~0ull : ((1ull << RBC) - 1)) << (ch * RBC);
      if (st(L.ab_pending + idx) > 0 && ((quiet >> idx) & 1ull) &&
          (ready & m) == m) {
        start_ab |= 1ull << idx;
        c.ab_rr += 1;
      }
    }
  }
  uint64_t mid = ~ready;  // banks with a subarray still refreshing
  for (int r = 0; r < d.R; ++r) {
    if (!((start_ab >> r) & 1ull)) continue;
    int end = t + P.RFC_AB;
    for (int b = r * NB; b < (r + 1) * NB; ++b) {
      if (P.sarp) {
        // SARP marks (and closes) only the target subarray ctr % S
        int ns = st(L.ctr + b) % S;
        st(L.ref_until + b * S + ns) = end;
        st(L.open_row + b * S + ns) = -1;
        st(L.ctr + b) += 1;
      } else {
        for (int s = 0; s < S; ++s) {
          st(L.ref_until + b * S + s) = end;
          st(L.open_row + b * S + s) = -1;
        }
      }
      mid |= 1ull << b;
    }
    int left = st(L.ab_pending + r) - 1;
    st(L.ab_pending + r) = left;
    st(L.rank_drain + r) = left > 0;
    c.refab += 1;
  }

  for (int b = 0; b < B; ++b) {
    if (!((picks >> b) & 1ull)) continue;
    int ctr = st(L.ctr + b);
    int ns = ctr % S;
    int bf = st(L.bank_free + b);
    int start = bf > t ? bf : t;
    // HiRA hidden row activation: a refresh of a subarray the in-flight
    // access is NOT using starts at t instead of waiting for the bank
    if (P.hra && ns != st(L.open_sub + b)) start = t;
    int end = start + P.RFC_PB;
    if (P.sarp) {
      st(L.ref_until + b * S + ns) = end;
      st(L.open_row + b * S + ns) = -1;
    } else {
      for (int s = 0; s < S; ++s) {
        st(L.ref_until + b * S + s) = end;
        st(L.open_row + b * S + s) = -1;
      }
    }
    st(L.ctr + b) = ctr + 1;
    st(L.issued + b) += 1;
    c.refpb += 1;
    int after = lag[b] - 1;  // due - issued, after this issue
    if (after < 0) after = -after;
    if (after > c.maxlag) c.maxlag = after;
    mid |= 1ull << b;
  }
  return mid;
}

// The head-of-queue request of a bank, as the arbiter sees it.
struct Head {
  int row, sub, arrive, is_write;
};

// ---- phase 5a: the best eligible bank of channel `ch` (or -1).
// `heads.has(b)` / `heads.get(b)` expose the bank queues; `drain_arb` is
// the drain flag snapshotted before any serve of this tick.
template <class Heads>
__device__ __forceinline__ int arbitrate_channel(
    const TickDims& d, const MachineLayout& L, const Cell& st, int t,
    int ch, const Heads& heads, const int* occ, uint64_t mid,
    bool drain_arb, Head& best_head) {
  const int RBC = d.NR * d.NB;
  int best = -1, best_score = -1;
  for (int b = ch * RBC; b < (ch + 1) * RBC; ++b) {
    if (!heads.has(b)) continue;
    if (st(L.rank_drain + b / d.NB)) continue;
    if (st(L.bank_free + b) > t) continue;
    Head h = heads.get(b);
    if (st(L.ref_until + b * d.S + h.sub) > t) continue;
    int sc = arbiter_score(t, drain_arb && h.is_write, occ ? occ[b] : 0,
                           h.row == st(L.open_row + b * d.S + h.sub),
                           (mid >> b) & 1ull, h.arrive);
    if (sc > best_score) {
      best = b;
      best_score = sc;
      best_head = h;
    }
  }
  return best;
}

// ---- phase 5b: start head `h` of bank `b` on channel `ch` at tick t.
// Updates the machine state, the counters and (for reads) the cell's
// latency histogram; returns the data-return tick.
__device__ __forceinline__ int serve_bank(
    const TickDims& d, const CellParams& P, const MachineLayout& L,
    const Cell& st, int* hist, size_t hist_stride, int t, int ch, int b,
    const Head& h, uint64_t mid, Counters& c) {
  bool hit = h.row == st(L.open_row + b * d.S + h.sub);
  int rank = b / d.NB;
  int lr = st(L.last_rank + ch);
  int lat = (hit ? P.HIT : P.MISS) +
            ((P.sarp && ((mid >> b) & 1ull)) ? P.SARP_PEN : 0) +
            ((h.is_write != 0) != (st(L.last_op + ch) != 0) ? P.TURN : 0) +
            ((lr >= 0 && lr != rank) ? P.RTR : 0);
  int done = t + lat;
  st(L.bank_free + b) = done + (h.is_write ? P.WR : 0);
  st(L.last_op + ch) = h.is_write ? 1 : 0;
  st(L.last_rank + ch) = rank;
  st(L.open_row + b * d.S + h.sub) = h.row;
  st(L.open_sub + b) = h.sub;
  if (h.is_write) {
    c.wpend -= 1;
    if (c.wpend <= d.LO) c.drain = 0;
    c.writes += 1;
  } else {
    int lrec = done - h.arrive;
    if (lrec > MAX_LAT_TICKS) lrec = MAX_LAT_TICKS;
    hist[(size_t)lrec * hist_stride] += 1;
    c.lat_sum += lrec;
    c.reads += 1;
  }
  if (hit) c.hits += 1; else c.misses += 1;
  if (done > c.last_done) c.last_done = done;
  return done;
}

// p99 tick index from a cell's latency histogram: the first bin whose
// running sum reaches ceil(0.99 * reads) == (99 * reads + 99) / 100;
// 0 when there were no reads.
__device__ __forceinline__ int p99_from_hist(const int* hist,
                                             size_t hist_stride,
                                             int reads) {
  int target = (99 * reads + 99) / 100;
  int cum = 0;
  for (int i = 0; i <= MAX_LAT_TICKS; ++i) {
    cum += hist[(size_t)i * hist_stride];
    if (cum >= target) return i;
  }
  return 0;
}
