// Tick-contract phases shared by the tick-loop megakernels, run by a
// GROUP of G lanes per cell: refresh debt (phase 3 / B), the policy
// decisions of every vectorized policy kind with SARP/HiRA subarray
// marking (phase 4 / C), and the packed-score arbitration and serve of one
// channel (phase 5 / D). The closed-loop kernel (sweep_megakernel.cu)
// drives them from its ring bank queues, the open-loop kernel
// (sweep_megakernel_open.cu) from its arrival FIFOs.
//
// The definitions these functions restate are `select_batch_torch`
// (repro_torch/core/sweep/policies.py) and `closed_body` / `open_body`
// (repro_torch/core/sweep/torchbody.py). All arithmetic is int32. Every
// `/` and `%` has a non-negative left operand, guarded ahead of the
// division.
//
// Lanes and banks. Lane l of a group owns banks l, l + G, l + 2G, ...
// (NBL slots, a compile-time count; slot j is bank l + G*j). What the
// serial definition computes bank after bank, lowest bank first, the
// group computes with warp-synchronous collectives masked to its lanes:
//   * a first maximum (ties toward the lowest bank) is the largest key
//     (`__reduce_max_sync`, lanes without a candidate give INT_MIN), then
//     the lowest bank holding it: `__ffs` of a ballot where a lane owns
//     one bank, else `__reduce_min_sync`. Where a lane owns one bank the
//     arbitration takes a single reduction: its score has SCORE_BITS (26)
//     bits, so the score and 31 - lane fit one non-negative int32. With
//     a lane mask known only at run time the compiler wraps each
//     `__reduce_*_sync` in a loop over the warp's distinct masks, while
//     ballots and shuffles take the mask as they are: reductions are
//     kept to what needs them;
//   * a set of banks is a `BankMask`, built by one ballot per slot, and
//     "every bank of this rank / channel" is a test of its bits;
//   * sums (demand pressure, issued writes) are `__reduce_add_sync`.
// Every collective sits in control flow that is uniform across the group
// (cells of one warp may diverge; lanes of one cell do not).
//
// State. A bank's machine state lives in its lane's registers
// (`bank_free`, `open_sub`, `ctr`, `issued`, the largest `ref_until` of
// its subarrays, and a copy of its rank's `ab_pending` / `rank_drain`
// and its channel's `last_op` / `last_rank`, which every lane of the
// rank or channel updates alike). The [S, B] subarray planes `ref_until`
// and `open_row` are read at a subarray chosen at run time, so they live
// in the group's shared memory, laid out [s][bank] and touched only by
// the bank's own lane. The cell's counters that steer the loop (`rr`,
// `ab_rr`, `wpend`, `drain`) are uniform across the group; the stats are
// lane partials, reduced once when the cell ends. The 4096-bin latency
// histogram is the group slot's, in global memory: the serving lane adds
// to it, and the group finds p99 in parallel at the end and zeroes it for
// the slot's next cell.
#pragma once
#include <limits.h>
#include <stdint.h>

#include "sweep_fields.h"
#include "sweep_score.cuh"

#define SWEEP_HIST_BINS (MAX_LAT_TICKS + 1)

// a + b for b > 0, held at INT_MAX: tick counters that step by tREFI
__device__ __forceinline__ int sat_add(int a, int b) {
  return a > INT_MAX - b ? INT_MAX : a + b;
}

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

// The G lanes of one cell: G consecutive lanes of a warp (G a power of
// two up to 32). Collectives return group-relative results: ballots and
// matches as G-bit masks with bit l for lane l.
template <int G>
struct Group {
  unsigned mask;  // the group's lanes in the warp
  int lane;       // 0 .. G-1
  int base;       // warp lane of lane 0

  __device__ __forceinline__ static Group here() {
    Group g;
    const int wl = threadIdx.x & 31;
    g.lane = threadIdx.x & (G - 1);
    g.base = wl & ~(G - 1);
    g.mask = (G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u)) << g.base;
    return g;
  }
  __device__ __forceinline__ unsigned below() const {
    return (1u << lane) - 1u;
  }
  __device__ __forceinline__ int max(int v) const {
    if constexpr (G == 1) return v; else return __reduce_max_sync(mask, v);
  }
  __device__ __forceinline__ int min(int v) const {
    if constexpr (G == 1) return v; else return __reduce_min_sync(mask, v);
  }
  __device__ __forceinline__ int sum(int v) const {
    if constexpr (G == 1) return v;
    else return (int)__reduce_add_sync(mask, (unsigned)v);
  }
  __device__ __forceinline__ unsigned ballot(bool p) const {
    if constexpr (G == 1) return p ? 1u : 0u;
    else return __ballot_sync(mask, p) >> base;
  }
  __device__ __forceinline__ bool any(bool p) const {
    if constexpr (G == 1) return p; else return __any_sync(mask, p) != 0;
  }
  __device__ __forceinline__ unsigned match(int v) const {
    if constexpr (G == 1) return 1u;
    else return __match_any_sync(mask, v) >> base;
  }
  __device__ __forceinline__ int bcast(int v, int src) const {
    if constexpr (G == 1) return v;
    else return __shfl_sync(mask, v, src, G);
  }
  // inclusive prefix sum over lanes 0 .. lane
  __device__ __forceinline__ int scan(int v) const {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      int n = __shfl_up_sync(mask, v, o, G);
      if (lane >= o) v += n;
    }
    return v;
  }
  __device__ __forceinline__ void sync() const {
    if constexpr (G > 1) __syncwarp(mask);
  }
};

// A set of a cell's banks, the same in every lane of the group: bank b is
// bit b of 32-bit word b / 32. Built from one predicate per bank slot.
template <int G, int NBL>
struct BankMask {
  static constexpr int NW = (G * NBL + 31) / 32;
  unsigned w[NW];

  __device__ __forceinline__ static BankMask of(const Group<G>& g,
                                                const bool (&p)[NBL]) {
    BankMask m;
#pragma unroll
    for (int i = 0; i < NW; ++i) m.w[i] = 0u;
#pragma unroll
    for (int j = 0; j < NBL; ++j) {
      const int bit = G * j;  // slot j's lanes hold banks bit .. bit+G-1
      m.w[bit >> 5] |= g.ballot(p[j]) << (bit & 31);
    }
    return m;
  }
  // every bank of [lo, lo + n) is in the set
  __device__ __forceinline__ bool all_in(int lo, int n) const {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      int a = lo - 32 * i, e = lo + n - 32 * i;
      a = a < 0 ? 0 : a;
      e = e > 32 ? 32 : e;
      if (e > a) {
        unsigned m = (e - a == 32 ? 0xffffffffu : ((1u << (e - a)) - 1u))
                     << a;
        ok = ok && (w[i] & m) == m;
      }
    }
    return ok;
  }
};

// The head-of-queue request of a bank, as the arbiter sees it (`core`:
// the closed loop's issuing core).
struct Head {
  int row, sub, arrive, w, core;
};

// Stat partials of one lane, summed (maxima: taken) over the group when
// the cell ends.
struct Partials {
  int reads, writes, hits, misses, refpb, refab, lat_sum, maxlag,
      last_done, max_lat;
};

// The machine state of one cell, spread over its group (see the header).
template <int G, int NBL>
struct Machine {
  static constexpr int BP = G * NBL;  // row length of the shared planes
  Group<G> g;
  TickDims d;
  CellParams P;
  int RBC;          // banks a channel
  int* ref_until;   // shared [S][BP]
  int* open_row;    // shared [S][BP]
  int* hist;        // global [SWEEP_HIST_BINS], this slot's
  // the slots' place in the hierarchy (fixed for a launch): rank, its
  // first bank, channel, and whether the bank is its rank's first
  int rank[NBL], rank_lo[NBL], chan[NBL];
  bool rank_first[NBL];
  // refresh schedule: banks' refreshes due so far and the tick the next
  // falls due; the tick the rank's next all-bank debt accrues
  int due[NBL], next_due[NBL], next_debt[NBL];
  int bank_free[NBL], open_sub[NBL], ctr[NBL], issued[NBL], ref_max[NBL];
  int ab_pending[NBL], rank_drain[NBL];  // of the slot's rank
  int last_op[NBL], last_rank[NBL];      // of the slot's channel
  int rr, ab_rr, wpend, drain;           // uniform over the group
  Partials s;                            // this lane's stat partials

  __device__ __forceinline__ int bank(int j) const { return g.lane + G * j; }
  __device__ __forceinline__ bool valid(int j) const {
    return bank(j) < d.B;
  }
  __device__ __forceinline__ int& ru(int j, int sub) const {
    return ref_until[sub * BP + bank(j)];
  }
  __device__ __forceinline__ int& orow(int j, int sub) const {
    return open_row[sub * BP + bank(j)];
  }

  // once a launch, after `g` and `d`: the slots' ranks and channels
  __device__ __forceinline__ void place() {
    RBC = d.NR * d.NB;
#pragma unroll
    for (int j = 0; j < NBL; ++j) {
      rank[j] = bank(j) / d.NB;
      rank_lo[j] = rank[j] * d.NB;
      chan[j] = bank(j) / RBC;
      rank_first[j] = bank(j) == rank_lo[j];
    }
  }

  // once a cell, after `P`: the t = 0 state
  __device__ __forceinline__ void init() {
    const int step = P.REFI / d.R;
#pragma unroll
    for (int j = 0; j < NBL; ++j) {
      due[j] = 0;
      next_due[j] = bank(j) * P.REFI_PB;
      // the debt of rank r accrues at r * step + k * tREFI, k >= 1
      next_debt[j] = sat_add(rank[j] * step, P.REFI);
      bank_free[j] = 0;
      open_sub[j] = -1;
      ctr[j] = 0;
      issued[j] = 0;
      ref_max[j] = 0;
      ab_pending[j] = 0;
      rank_drain[j] = 0;
      last_op[j] = 0;
      last_rank[j] = -1;
      for (int sub = 0; sub < d.S; ++sub) {
        ru(j, sub) = 0;
        orow(j, sub) = -1;
      }
    }
    rr = ab_rr = wpend = drain = 0;
    s.reads = s.writes = s.hits = s.misses = s.refpb = s.refab = 0;
    s.lat_sum = s.maxlag = s.last_done = s.max_lat = 0;
  }

  // ---- phase 3: per-rank all-bank refresh debt, rank r staggered
  // r * (tREFI / R) after rank 0 (active cells of level-'ab' policies):
  // at t > r * step with (t - r * step) % tREFI == 0, that is at
  // `next_debt`, since t takes every value in turn; each bank's lane
  // keeps its rank's copy
  __device__ __forceinline__ void refresh_debt(int t) {
    if (!P.level_ab) return;
#pragma unroll
    for (int j = 0; j < NBL; ++j) {
      if (valid(j) && t == next_debt[j]) {
        ab_pending[j] += 1;
        rank_drain[j] = 1;
        next_debt[j] = sat_add(t, P.REFI);
      }
    }
  }

  // The bank of the first candidate with the largest key (-1: none),
  // the same in every lane.
  __device__ __forceinline__ int first_max(const bool (&cand)[NBL],
                                           const int (&key)[NBL]) const {
    int bk = INT_MIN, bb = INT_MAX;
#pragma unroll
    for (int j = 0; j < NBL; ++j)
      if (cand[j] && (bb == INT_MAX || key[j] > bk)) {
        bk = key[j];
        bb = bank(j);
      }
    const int best = g.max(bk);
    const bool holds = bb != INT_MAX && bk == best;
    if constexpr (NBL == 1) {
      // a lane's one bank is its lane: the lowest lane holding the key
      return __ffs(g.ballot(holds)) - 1;
    } else {
      const int b = g.min(holds ? bb : INT_MAX);
      return b == INT_MAX ? -1 : b;
    }
  }

  // ---- phase 4a: the vectorized per-bank policy families
  // (`select_batch`): sets `pick` for this lane's slots and advances the
  // round-robin pointer.
  __device__ __forceinline__ void policy_select(const int (&lag)[NBL],
                                                const bool (&rdy)[NBL],
                                                const bool (&idl)[NBL],
                                                const int (&dem)[NBL],
                                                bool ww, bool (&pick)[NBL]) {
    const int kind = P.kind, bud = P.budget;
#pragma unroll
    for (int j = 0; j < NBL; ++j) pick[j] = false;
    if (kind < KIND_RR || kind >= KIND_CUSTOM) return;
    // forced sweep: every bank at the postpone edge refreshes now, and any
    // forced pick exhausts the regular allowance (max_issues == 1)
    bool any_forced = false;
#pragma unroll
    for (int j = 0; j < NBL; ++j) {
      pick[j] = valid(j) && lag[j] >= bud && rdy[j];
      any_forced = any_forced || pick[j];
    }
    if (g.any(any_forced)) return;

    if (kind == KIND_RR) {
      const int idx = rr % d.B;
      bool hit = false;
#pragma unroll
      for (int j = 0; j < NBL; ++j) {
        pick[j] = bank(j) == idx && lag[j] > 0 && rdy[j];
        hit = hit || pick[j];
      }
      if (g.any(hit)) rr += 1;
      return;
    }
    bool cand[NBL];
    int key[NBL];
    int best = -1;
    if (kind == KIND_DARP || kind == KIND_RDARP) {
      const bool pull = ww && P.wrp;
      bool zero[NBL];
#pragma unroll
      for (int j = 0; j < NBL; ++j) zero[j] = dem[j] == 0;
      // a rank with no demand at all (`rank_idle`), for the rank-aware key
      const BankMask<G, NBL> idle_rank =
          kind == KIND_RDARP ? BankMask<G, NBL>::of(g, zero)
                             : BankMask<G, NBL>{};
#pragma unroll
      for (int j = 0; j < NBL; ++j) {
        cand[j] = valid(j) && rdy[j] && idl[j] && zero[j] &&
                  (pull ? lag[j] > -bud : lag[j] > 0);
        key[j] = kind == KIND_DARP
                     ? lag[j]
                     : (int)idle_rank.all_in(rank_lo[j], d.NB) * POLICY_KD +
                           (lag[j] + bud);
      }
      best = first_max(cand, key);
    } else if (kind == KIND_ELASTIC) {
      int mine = 0;
#pragma unroll
      for (int j = 0; j < NBL; ++j) mine += valid(j) ? dem[j] : 0;
      const int pressure = g.sum(mine);
#pragma unroll
      for (int j = 0; j < NBL; ++j) {
        if (pressure == 0)
          cand[j] = rdy[j] && idl[j] && lag[j] > -bud;
        else if (pressure <= d.B)
          cand[j] = rdy[j] && idl[j] && dem[j] == 0 && lag[j] > 0;
        else
          cand[j] = rdy[j] && lag[j] >= P.urgent;
        cand[j] = cand[j] && valid(j);
        key[j] = lag[j];
      }
      best = first_max(cand, key);
    } else if (kind == KIND_HIRA) {
      // behind-access first, idle fallback, write-window pull-in last
      int kdl[NBL];
#pragma unroll
      for (int j = 0; j < NBL; ++j) {
        cand[j] = valid(j) && rdy[j] && lag[j] > 0 && dem[j] > 0;
        kdl[j] = dem[j] * POLICY_KD + (lag[j] + bud);
      }
      best = first_max(cand, kdl);
      if (best < 0) {
#pragma unroll
        for (int j = 0; j < NBL; ++j)
          cand[j] = valid(j) && rdy[j] && idl[j] && lag[j] > 0 &&
                    dem[j] == 0;
        best = first_max(cand, lag);
      }
      if (best < 0 && ww) {
        // reached only when neither a hot nor a cold candidate exists
#pragma unroll
        for (int j = 0; j < NBL; ++j)
          cand[j] = valid(j) && rdy[j] && lag[j] > -bud;
        best = first_max(cand, kdl);
      }
    }
#pragma unroll
    for (int j = 0; j < NBL; ++j) pick[j] = bank(j) == best;
  }

  // Mark subarray `ns` of slot j (SARP), or all of them, refreshing
  // until `end`; the bank then is busy refreshing until `end`, which is
  // past every earlier mark (a refresh starts only on a ready bank).
  __device__ __forceinline__ void mark(int j, int ns, int end) {
    if (P.sarp) {
      ru(j, ns) = end;
      orow(j, ns) = -1;
    } else {
      for (int sub = 0; sub < d.S; ++sub) {
        ru(j, sub) = end;
        orow(j, sub) = -1;
      }
    }
    ref_max[j] = ref_max[j] > end ? ref_max[j] : end;
  }

  // ---- phase 4: refresh decisions of an ACTIVE cell at tick t. `dem` is
  // each slot's queue depth. Applies all-bank starts (ref_ab,
  // staggered_ab) and per-bank picks with SARP/HiRA subarray marking, and
  // sets `mid`: any subarray of the bank mid-refresh AFTER the marks (the
  // arbitration step's `bank_mid_ref`).
  __device__ __forceinline__ void refresh_decide(int t, const int (&dem)[NBL],
                                                 bool (&mid)[NBL]) {
    const int NB = d.NB;
    int lag[NBL];
    bool rdy[NBL], idl[NBL], pick[NBL], start[NBL];
#pragma unroll
    for (int j = 0; j < NBL; ++j) {
      // due = t >= phase ? (t - phase) / tREFI + 1 : 0 with phase = b *
      // tREFI_pb, counted as t passes each due tick
      while (t >= next_due[j]) {
        due[j] += 1;
        next_due[j] = sat_add(next_due[j], P.REFI);
      }
      lag[j] = due[j] - issued[j];
      rdy[j] = valid(j) && ref_max[j] <= t;
      idl[j] = valid(j) && bank_free[j] <= t;
      start[j] = false;
    }
    policy_select(lag, rdy, idl, dem, drain != 0, pick);

    // all-bank starts: ref_ab starts every quiet rank that owes a refresh;
    // staggered_ab walks the ranks round-robin and also needs the whole
    // channel free of refreshes
    if (P.kind == KIND_AB || P.kind == KIND_STAG) {
      bool q[NBL];
#pragma unroll
      for (int j = 0; j < NBL; ++j) q[j] = rdy[j] && idl[j];
      const BankMask<G, NBL> quiet = BankMask<G, NBL>::of(g, q);
      if (P.kind == KIND_AB) {
#pragma unroll
        for (int j = 0; j < NBL; ++j)
          start[j] = valid(j) && ab_pending[j] > 0 &&
                     quiet.all_in(rank_lo[j], NB);
      } else {
        const int idx = ab_rr % d.R;
        const int ch = idx / d.NR;
        bool owes = false;
#pragma unroll
        for (int j = 0; j < NBL; ++j)
          owes = owes || (valid(j) && rank[j] == idx && ab_pending[j] > 0);
        const BankMask<G, NBL> ready = BankMask<G, NBL>::of(g, rdy);
        if (g.any(owes) && quiet.all_in(idx * NB, NB) &&
            ready.all_in(ch * RBC, RBC)) {
#pragma unroll
          for (int j = 0; j < NBL; ++j)
            start[j] = valid(j) && rank[j] == idx;
          ab_rr += 1;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NBL; ++j) {
      mid[j] = !rdy[j];  // a subarray still refreshing
      if (start[j]) {
        // SARP marks (and closes) only the target subarray ctr % S
        mark(j, ctr[j] % d.S, t + P.RFC_AB);
        if (P.sarp) ctr[j] += 1;
        mid[j] = true;
        const int left = ab_pending[j] - 1;
        ab_pending[j] = left;
        rank_drain[j] = left > 0;
        if (rank_first[j]) s.refab += 1;
      }
      if (pick[j]) {
        const int ns = ctr[j] % d.S;
        int start_t = bank_free[j] > t ? bank_free[j] : t;
        // HiRA hidden row activation: a refresh of a subarray the
        // in-flight access is NOT using starts at t instead of waiting
        // for the bank
        if (P.hra && ns != open_sub[j]) start_t = t;
        mark(j, ns, start_t + P.RFC_PB);
        ctr[j] += 1;
        issued[j] += 1;
        s.refpb += 1;
        int after = lag[j] - 1;  // due - issued, after this issue
        if (after < 0) after = -after;
        if (after > s.maxlag) s.maxlag = after;
        mid[j] = true;
      }
    }
  }

  // ---- phase 5a: the best eligible bank of channel `ch` (or -1), the
  // same in every lane. `has`/`h` are the slots' queue heads, `occ` the
  // occupancy field (0 in the open form); `drain_arb` is the drain flag
  // snapshotted before any serve of this tick. Scores read the state
  // before any serve of the tick: channels touch disjoint banks.
  __device__ __forceinline__ int arbitrate(int t, int ch,
                                           const bool (&has)[NBL],
                                           const Head (&h)[NBL],
                                           const int (&occ)[NBL],
                                           const bool (&mid)[NBL],
                                           bool drain_arb) const {
    int bk = -1, bb = INT_MAX;
#pragma unroll
    for (int j = 0; j < NBL; ++j) {
      if (!valid(j) || chan[j] != ch || !has[j] || rank_drain[j] ||
          bank_free[j] > t || ru(j, h[j].sub) > t)
        continue;
      const int sc = arbiter_score(t, drain_arb && h[j].w, occ[j],
                                   h[j].row == orow(j, h[j].sub), mid[j],
                                   h[j].arrive);
      if (sc > bk) {
        bk = sc;
        bb = bank(j);
      }
    }
    if constexpr (NBL == 1) {
      // a lane's one bank is its lane: one reduction over (score, lowest
      // lane first), since a score has SCORE_BITS bits
      static_assert(SCORE_BITS + 5 <= 31, "score and lane exceed int32");
      const int best = g.max(bk < 0 ? -1 : (bk << 5) | (31 - g.lane));
      return best < 0 ? -1 : 31 - (best & 31);
    } else {
      const int best = g.max(bk);
      if (best < 0) return -1;
      return g.min(bk == best ? bb : INT_MAX);
    }
  }

  // ---- phase 5b: start the head of bank `win` (channel `ch`) at tick t.
  // The bank's lane updates the bank, its stat partials and the
  // histogram, and returns the data-return tick in `done`; every lane of
  // the channel updates its copy of the bus state. Returns the write
  // flag, the same in every lane.
  __device__ __forceinline__ int serve(int t, int ch, int win,
                                       const Head (&h)[NBL],
                                       const bool (&mid)[NBL], int& done) {
    const int wl = win & (G - 1);
    int w = 0, rk = 0;
    done = 0;
    if (g.lane == wl) {
#pragma unroll
      for (int j = 0; j < NBL; ++j) {
        if (bank(j) != win) continue;
        const Head hh = h[j];
        int& orw = orow(j, hh.sub);
        const bool hit = hh.row == orw;
        const int lr = last_rank[j];
        rk = rank[j];
        const int lat = (hit ? P.HIT : P.MISS) +
                        ((P.sarp && mid[j]) ? P.SARP_PEN : 0) +
                        ((hh.w != 0) != (last_op[j] != 0) ? P.TURN : 0) +
                        ((lr >= 0 && lr != rk) ? P.RTR : 0);
        done = t + lat;
        bank_free[j] = done + (hh.w ? P.WR : 0);
        orw = hh.row;
        open_sub[j] = hh.sub;
        if (hh.w) {
          s.writes += 1;
        } else {
          int lrec = done - hh.arrive;
          if (lrec > MAX_LAT_TICKS) lrec = MAX_LAT_TICKS;
          atomicAdd(hist + lrec, 1);
          if (lrec > s.max_lat) s.max_lat = lrec;
          s.lat_sum += lrec;
          s.reads += 1;
        }
        if (hit) s.hits += 1; else s.misses += 1;
        if (done > s.last_done) s.last_done = done;
        w = hh.w;
      }
    }
    // the write flag and the bank's rank, from the bank's lane
    const int wr = g.bcast(rk * 2 + w, wl);
    w = wr & 1;
#pragma unroll
    for (int j = 0; j < NBL; ++j)
      if (valid(j) && chan[j] == ch) {
        last_op[j] = w;
        last_rank[j] = wr >> 1;
      }
    return w;
  }

  // Write serves of one tick, `n_w` of them: the buffer drains, and the
  // drain mode ends if it fell to the low watermark at any serve - that
  // is, at the last, since `wpend` only falls.
  __device__ __forceinline__ void writes_served(int n_w) {
    wpend -= n_w;
    if (n_w > 0 && wpend <= d.LO) drain = 0;
  }

  // The cell's stats row (`out`, written by lane 0). p99 is the first
  // histogram bin whose running sum reaches ceil(0.99 * reads) ==
  // (99 * reads + 99) / 100, 0 without reads. Only bins up to the largest
  // latency recorded can be non-zero: each lane sums a contiguous run of
  // them, a prefix sum over the lanes finds the run that holds the bin,
  // and that lane walks it. Every lane zeroes its run for the slot's next
  // cell.
  __device__ __forceinline__ void write_stats(int* out, bool finished) {
    g.sync();  // every serve's histogram update is visible
    const int reads = g.sum(s.reads);
    const int target = (99 * reads + 99) / 100;
    const int bins = g.max(s.max_lat) + 1;
    const int run = (bins + G - 1) / G;
    const int lo = g.lane * run;
    const int hi = lo + run < bins ? lo + run : bins;
    int part = 0;  // read past L1: the serves added at L2
    for (int i = lo; i < hi; ++i) part += __ldcg(hist + i);
    const int incl = g.scan(part);
    const unsigned reached = g.ballot(incl >= target);
    const int owner = __ffs(reached) - 1;
    int p99 = 0;
    if (g.lane == owner) {
      int cum = incl - part;
      for (int i = lo; i < hi; ++i) {
        cum += __ldcg(hist + i);
        if (cum >= target) {
          p99 = i;
          break;
        }
      }
    }
    for (int i = lo; i < hi; ++i) hist[i] = 0;
    g.sync();  // zeroed before the slot's next cell adds to it
    p99 = g.bcast(p99, owner < 0 ? 0 : owner);
    const int writes = g.sum(s.writes), hits = g.sum(s.hits);
    const int misses = g.sum(s.misses), refpb = g.sum(s.refpb);
    const int refab = g.sum(s.refab), lat_sum = g.sum(s.lat_sum);
    const int maxlag = g.max(s.maxlag), last_done = g.max(s.last_done);
    if (g.lane == 0) {
      out[MS_READS] = reads;
      out[MS_WRITES] = writes;
      out[MS_HITS] = hits;
      out[MS_MISSES] = misses;
      out[MS_REFPB] = refpb;
      out[MS_REFAB] = refab;
      out[MS_LATSUM] = lat_sum;
      out[MS_MAXLAG] = maxlag;
      out[MS_LASTDONE] = last_done;
      out[MS_P99] = p99;
      out[MS_FINISHED] = finished ? 1 : 0;
    }
  }
};

// How a launch is laid out: G lanes a cell, `cells` cells (groups) a
// block, `blocks` resident blocks that take cells from a shared counter
// until none is left (a group slot per resident cell, each with its own
// histogram and, closed, ring queues), and the dynamic shared memory a
// block takes. Filled by the mode's plan function.
struct LaunchPlan {
  int G, cells, blocks, smem_bytes, regs, local_bytes;
};

// Resident blocks for `plan` on the current device: enough to hold
// every cell at once, at most what the SMs hold at once.
template <class K>
__host__ inline int plan_blocks(K kernel, LaunchPlan& plan, int n) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  plan.regs = fa.numRegs;
  plan.local_bytes = (int)fa.localSizeBytes;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, plan.cells * plan.G, plan.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int want = (n + plan.cells - 1) / plan.cells;
  plan.blocks = want < sms * per_sm ? want : sms * per_sm;
  return 0;
}

// Cells a block for a request of `cells`: at least 1, at most what 1024
// threads and 227 KB of shared memory (`cell_bytes` a cell) hold.
__host__ inline int clamp_cells(int cells, int G, int cell_bytes) {
  const int max_threads = 1024 / G, max_smem = (227 * 1024) / cell_bytes;
  int c = cells < 1 ? 1 : cells;
  c = c < max_threads ? c : max_threads;
  return c < max_smem ? c : max_smem;
}
