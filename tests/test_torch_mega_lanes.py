"""The group-of-lanes orderings of the tick-loop megakernels A1 and A2
(`csrc/sweep_tick.cuh`, `csrc/sweep_megakernel*.cu`), emulated in plain
torch on the CPU and held against the sequential definitions they
replace: the serial bank and core walks of the tick contract, as
`repro_torch.core.sweep.policies` / `torchbody` and the kernels' stat
reduction (`sweep_megakernel._pack_stats`) define them.

A cell runs on a group of G lanes; lane l owns banks l, l + G, ... (NBL
slots) and cores l, l + G, .... Each warp collective the kernels use is
emulated over the lane axis of a `[cells, G]` tensor: a ballot is a bit
mask, `__reduce_*_sync` a max / min / sum, `__match_any_sync` the mask of
lanes holding the same value, `__ffs` the lowest set bit. Inputs are made
from a seed with numpy, random and adversarial (all keys equal, ties
across ranks and channels, two and four cores issuing to one bank in one
tick, writers beyond the buffer room, two channels parking reads of one
core in one tick, a 40-bank cell whose lanes own two banks each). The
tolerance is none: every result must be equal."""
import numpy as np
import pytest
import torch

from repro_torch.core.sweep.engine import MAX_LAT_TICKS
from repro_torch.core.sweep.fields import (AGE_CAP, MEGA_NSTAT, MS_P99,
                                           OCC_CAP, SCORE_BITS, W_HIT,
                                           W_NOCONF, W_OCC, W_WRITE)
from repro_torch.core.sweep.policies import _pick_one_torch
from repro_torch.kernels.sweep_megakernel import _pack_stats

I64 = torch.int64
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
PAD = 1 << 30


# ------------------------------------------------------ emulated collectives
def ballot(pred):
    """`__ballot_sync` over a group: [n, G] bool -> [n] mask, bit l."""
    G = pred.shape[1]
    return (pred.to(I64) << torch.arange(G)).sum(dim=1)


def popc(x):
    return torch.tensor([bin(int(v)).count("1") for v in x.flatten()],
                        dtype=I64).reshape(x.shape)


def ffs(x):
    """`__ffs`: 1 + the lowest set bit, 0 for none."""
    return torch.tensor([(int(v) & -int(v)).bit_length() for v in
                         x.flatten()], dtype=I64).reshape(x.shape)


def match_any(v):
    """`__match_any_sync`: per lane, the mask of lanes holding its value."""
    G = v.shape[1]
    same = v[:, :, None] == v[:, None, :]
    return (same.to(I64) << torch.arange(G)).sum(dim=2)


def below(G):
    return (1 << torch.arange(G, dtype=I64)) - 1


def lanes(cand_or_key, G, fill):
    """[n, B] per bank -> [n, G, NBL]: lane l, slot j holds bank l + G*j."""
    n, B = cand_or_key.shape
    nbl = -(-B // G)
    pad = torch.full((n, G * nbl - B), fill, dtype=cand_or_key.dtype)
    x = torch.cat([cand_or_key, pad], dim=1)
    return x.reshape(n, nbl, G).transpose(1, 2)


def serial_first_max(cand, key):
    """The serial walk (lowest bank first, replace on a strictly greater
    key): `_pick_one_torch`, as a bank index, -1 for none."""
    picks = _pick_one_torch(cand, key, torch.ones(cand.shape[0],
                                                  dtype=torch.bool))
    return torch.where(picks.any(dim=1), picks.to(I64).argmax(dim=1), -1)


def group_first_max(cand, key, G):
    """`Machine::first_max`: each lane's first maximum over its slots,
    then the largest key (`__reduce_max_sync`) and the lowest bank holding
    it (`__reduce_min_sync`)."""
    c, k = lanes(cand, G, False), lanes(key.to(I64), G, 0)
    n, _, nbl = c.shape
    bk = torch.full((n, G), INT_MIN, dtype=I64)
    bb = torch.full((n, G), INT_MAX, dtype=I64)
    for j in range(nbl):
        take = c[:, :, j] & ((bb == INT_MAX) | (k[:, :, j] > bk))
        bk = torch.where(take, k[:, :, j], bk)
        bb = torch.where(take, torch.arange(G) + G * j, bb)
    best = bk.max(dim=1).values
    b = torch.where((bb != INT_MAX) & (bk == best[:, None]), bb,
                    INT_MAX).min(dim=1).values
    return torch.where(b == INT_MAX, -1, b)


def ballot_first_max(cand, key):
    """One bank a lane: the largest key, then `__ffs` of the ballot of the
    candidates holding it."""
    k = torch.where(cand, key.to(I64), INT_MIN)
    best = k.max(dim=1).values
    bits = ballot(cand & (k == best[:, None]))
    return ffs(bits) - 1


# ------------------------------------------------------------- first maxima
def _keys(case, n, B, seed):
    rs = np.random.RandomState(seed)
    cand = rs.rand(n, B) < 0.6
    if case == "random":
        key = rs.randint(-40, 40, (n, B))
    elif case == "all_equal":
        key = np.full((n, B), 7)
        cand = np.ones((n, B), bool)
    elif case == "two_values":            # ties everywhere, across ranks
        key = rs.randint(0, 2, (n, B)) * 5
    elif case == "none":
        key = rs.randint(-40, 40, (n, B))
        cand = np.zeros((n, B), bool)
    elif case == "last_only":
        key = rs.randint(-40, 40, (n, B))
        cand = np.zeros((n, B), bool)
        cand[:, -1] = True
    else:                                  # "rdarp": rank_idle * KD + lag
        key = rs.randint(0, 2, (n, B)) * 64 + rs.randint(-3, 3, (n, B))
    return torch.from_numpy(cand), torch.from_numpy(key.astype(np.int32))


@pytest.mark.parametrize("case", ["random", "all_equal", "two_values",
                                  "none", "last_only", "rdarp"])
@pytest.mark.parametrize("G,B", [(8, 8), (16, 12), (32, 32), (32, 40),
                                 (32, 128), (1, 8)])
def test_group_first_max_equals_serial_walk(case, G, B):
    cand, key = _keys(case, 257, B, seed=B * 7 + G)
    want = serial_first_max(cand, key)
    assert torch.equal(group_first_max(cand, key, G), want)
    if B <= G:
        assert torch.equal(ballot_first_max(cand, key), want)


def test_forty_bank_cell_lanes_own_two_banks():
    """B = 40 (5 ranks x 8 banks) on 32 lanes: lanes 0-7 own banks l and
    l + 32; the maximum sits in the second slot, and ties straddle it."""
    cand = torch.ones((3, 40), dtype=torch.bool)
    key = torch.zeros((3, 40), dtype=torch.int32)
    key[0, 35] = 9                         # lane 3, slot 1
    key[1, [3, 35]] = 9                    # tie inside lane 3
    key[2, [35, 4]] = 9                    # tie across lanes 3 and 4
    got = group_first_max(cand, key, 32)
    assert got.tolist() == [35, 3, 4]
    assert torch.equal(got, serial_first_max(cand, key))


# ------------------------------------------------------------ arbitration
def serial_arbitrate(score, RBC):
    """Per channel, the first bank with the largest eligible score (-1:
    ineligible) - `arbitrate_channel`'s walk."""
    n, B = score.shape
    out = []
    for ch in range(B // RBC):
        s = score[:, ch * RBC:(ch + 1) * RBC]
        b = torch.where(s.max(dim=1).values >= 0,
                        s.to(I64).argmax(dim=1) + ch * RBC, -1)
        out.append(b)
    return torch.stack(out, dim=1)


def packed_arbitrate(score, RBC):
    """One bank a lane: one `__reduce_max_sync` of (score << 5) | (31 -
    lane) over the channel's lanes."""
    n, G = score.shape
    lane = torch.arange(G, dtype=I64)
    key = torch.where(score < 0, -1, (score.to(I64) << 5) | (31 - lane))
    out = []
    for ch in range(G // RBC):
        best = key[:, ch * RBC:(ch + 1) * RBC].max(dim=1).values
        out.append(torch.where(best < 0, -1, 31 - (best & 31)))
    return torch.stack(out, dim=1)


def test_packed_score_and_lane_fit_int32():
    top = W_WRITE + OCC_CAP * W_OCC + W_HIT + W_NOCONF + AGE_CAP
    assert top < (1 << SCORE_BITS)
    assert ((top << 5) | 31) <= INT_MAX


@pytest.mark.parametrize("case", ["random", "ties", "top_scores",
                                  "ineligible"])
@pytest.mark.parametrize("G,RBC", [(8, 8), (32, 16), (32, 8), (16, 8)])
def test_packed_arbitration_equals_channel_walk(case, G, RBC):
    rs = np.random.RandomState(G + RBC)
    n = 300
    top = W_WRITE + OCC_CAP * W_OCC + W_HIT + W_NOCONF + AGE_CAP
    if case == "random":
        s = rs.randint(-1, 1 << SCORE_BITS, (n, G))
    elif case == "ties":                   # equal scores across ranks
        s = rs.choice([-1, W_HIT + 3, W_HIT + 3, W_NOCONF], (n, G))
    elif case == "top_scores":
        s = rs.choice([top, top - 1, -1], (n, G))
    else:
        s = np.full((n, G), -1)
        s[::3, rs.randint(0, G)] = 5
    score = torch.from_numpy(s.astype(np.int32))
    assert torch.equal(packed_arbitrate(score, RBC),
                       serial_arbitrate(score, RBC))


# ---------------------------------------------------- phase 1: core issue
def serial_issue(elig, head_w, hb, out_ok, wroom, tail):
    """Closed phase 1 as the serial walk does it, core by core: a write
    issues while the writers before it leave room, and cores that target
    one bank take consecutive ring slots."""
    n, C = elig.shape
    tail = tail.clone()
    issue = torch.zeros((n, C), dtype=torch.bool)
    slot = torch.full((n, C), -1, dtype=I64)
    for g in range(n):
        writers = 0
        for c in range(C):
            if not elig[g, c]:
                continue
            if head_w[g, c]:
                ok = writers < int(wroom[g])
                writers += 1
            else:
                ok = bool(out_ok[g, c])
            if ok:
                issue[g, c] = True
                slot[g, c] = tail[g, hb[g, c]]
                tail[g, hb[g, c]] += 1
    return issue, slot, tail


def group_issue(elig, head_w, hb, out_ok, wroom, tail, G):
    """The kernel's phase 1: rounds of G cores (lane l holds core r*G +
    l); a writer's rank is `popc(ballot & lanes_below)`, a ring offset
    `popc(match_any(hb) & issuers & lanes_below)`, and the last issuer of
    a bank advances its tail by the count."""
    n, C = elig.shape
    tail = tail.clone()
    issue = torch.zeros((n, C), dtype=torch.bool)
    slot = torch.full((n, C), -1, dtype=I64)
    writers = torch.zeros(n, dtype=I64)
    for r0 in range(0, C, G):
        cs = slice(r0, min(C, r0 + G))
        w = min(C, r0 + G) - r0

        def lane(x, fill):
            out = torch.full((n, G), fill, dtype=x.dtype)
            out[:, :w] = x[:, cs]
            return out
        el, hw, ok_r = lane(elig, False), lane(head_w, False), lane(out_ok,
                                                                     False)
        hw = hw & el
        wbits = ballot(hw)
        rank = writers[:, None] + popc(wbits[:, None] & below(G))
        iss = el & torch.where(hw, rank < wroom[:, None], ok_r)
        writers = writers + popc(wbits)
        hbi = torch.where(iss, lane(hb, -1), -1)
        same = match_any(hbi) & ballot(iss)[:, None]
        off, cnt = popc(same & below(G)), popc(same)
        base = tail.gather(1, hbi.clamp(min=0))
        s = base + off
        last = iss & (off == cnt - 1)
        for g, l in zip(*torch.nonzero(last, as_tuple=True)):
            tail[g, hbi[g, l]] = base[g, l] + cnt[g, l]
        issue[:, cs] = iss[:, :w]
        slot[:, cs] = torch.where(iss, s, -1)[:, :w]
    return issue, slot, tail


def _issue_inputs(case, n, C, B, seed):
    rs = np.random.RandomState(seed)
    elig = rs.rand(n, C) < 0.8
    head_w = rs.rand(n, C) < 0.5
    hb = rs.randint(0, B, (n, C))
    out_ok = rs.rand(n, C) < 0.7
    wroom = rs.randint(-1, C + 1, n)
    if case == "two_cores_one_bank":
        hb[:, 1] = hb[:, 0]
        elig[:, :2] = True
    elif case == "four_cores_one_bank":
        hb[:, :4] = hb[:, [0]]
        elig[:, :4] = True
        out_ok[:, :4] = True
    elif case == "writers_beyond_room":
        head_w[:] = True
        elig[:] = True
        wroom = rs.randint(-2, 3, n)
    elif case == "all_one_bank":
        hb[:] = 3 % B
    tail = rs.randint(0, 50, (n, B))
    t = lambda a: torch.from_numpy(np.asarray(a))
    return (t(elig), t(head_w), t(hb).to(I64), t(out_ok), t(wroom).to(I64),
            t(tail).to(I64))


@pytest.mark.parametrize("case", ["random", "two_cores_one_bank",
                                  "four_cores_one_bank",
                                  "writers_beyond_room", "all_one_bank"])
@pytest.mark.parametrize("G,C,B", [(8, 4, 8), (32, 8, 32), (32, 40, 8),
                                   (1, 4, 8)])
def test_group_core_issue_equals_core_order(case, G, C, B):
    args = _issue_inputs(case, 200, C, B, seed=C * 11 + G)
    want = serial_issue(*args)
    got = group_issue(*args, G)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------- sums and bank masks
@pytest.mark.parametrize("seed", [0, 1])
def test_issued_writes_and_active_share_one_reduction(seed):
    """Phase 1 sums `n_wr + (active ? 0x10000 : 0)` in one reduction: the
    low half is the issued writes, the high half the active cores."""
    rs = np.random.RandomState(seed)
    n_wr = torch.from_numpy(rs.randint(0, 2, (500, 32)))
    act = torch.from_numpy(rs.rand(500, 32) < 0.3)
    both = (n_wr + act.to(I64) * 0x10000).sum(dim=1)
    assert torch.equal(both & 0xffff, n_wr.sum(dim=1))
    assert torch.equal((both >> 16) != 0, act.any(dim=1))


def bank_mask(pred, G):
    """`BankMask::of`: one ballot per slot j, placed at bit G*j."""
    p = lanes(pred, G, False)
    n, _, nbl = p.shape
    words = torch.zeros((n, -(-G * nbl // 32)), dtype=I64)
    for j in range(nbl):
        bit = G * j
        words[:, bit >> 5] |= ballot(p[:, :, j]) << (bit & 31)
    return words


def all_in(words, lo, n_banks):
    """`BankMask::all_in`: every bank of [lo, lo + n) is set."""
    ok = torch.ones(words.shape[0], dtype=torch.bool)
    for i in range(words.shape[1]):
        a = max(lo - 32 * i, 0)
        e = min(lo + n_banks - 32 * i, 32)
        if e > a:
            m = ((1 << (e - a)) - 1) << a
            ok &= (words[:, i] & m) == m
    return ok


@pytest.mark.parametrize("G,NB,NR,NC", [(8, 8, 1, 1), (16, 8, 2, 1),
                                        (32, 8, 2, 2), (32, 8, 5, 1),
                                        (32, 16, 4, 2), (32, 8, 32, 1),
                                        (1, 8, 1, 1)])
def test_bank_masks_answer_rank_and_channel_questions(G, NB, NR, NC):
    """`quiet` ranks, a channel all ready (staggered_ab), `rank_idle`
    (rank-aware DARP: no demand on any bank of the rank) and ELASTIC's
    summed pressure, against the per-bank planes."""
    B = NB * NR * NC
    rs = np.random.RandomState(B + G)
    n = 300
    quiet = torch.from_numpy(rs.rand(n, B) < 0.9)
    quiet[::4] = True                      # whole ranks quiet
    dem = torch.from_numpy(rs.randint(0, 3, (n, B)) * (rs.rand(n, B) < 0.2))
    qm = bank_mask(quiet, G)
    zm = bank_mask(dem == 0, G)
    for r in range(NR * NC):
        rank = slice(r * NB, (r + 1) * NB)
        assert torch.equal(all_in(qm, r * NB, NB), quiet[:, rank].all(1))
        assert torch.equal(all_in(zm, r * NB, NB),
                           dem.reshape(n, -1, NB).sum(2)[:, r] == 0)
    RBC = NR * NB
    for ch in range(NC):
        assert torch.equal(all_in(qm, ch * RBC, RBC),
                           quiet[:, ch * RBC:(ch + 1) * RBC].all(1))
    part = lanes(dem, G, 0).sum(dim=2)     # each lane's slots
    assert torch.equal(part.sum(dim=1), dem.sum(dim=1))


# ------------------------------------------------------------ drain rule
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drain_clears_as_at_the_first_low_serve(seed):
    """Serial: each write serve lowers `wpend` and clears the drain mode
    once it is at most LO. Group: `wpend -= n_w`, and the mode clears if
    a write was served and `wpend <= LO` after the tick's serves."""
    rs = np.random.RandomState(seed)
    for _ in range(2000):
        wpend, lo = int(rs.randint(0, 12)), int(rs.randint(0, 8))
        drain = bool(rs.rand() < 0.7)
        writes = rs.rand(int(rs.randint(1, 5))) < 0.6
        w_s, d_s = wpend, drain
        for w in writes:                   # channels in channel order
            if w:
                w_s -= 1
                if w_s <= lo:
                    d_s = False
        n_w = int(writes.sum())
        w_g, d_g = wpend - n_w, drain and not (n_w > 0 and wpend - n_w <= lo)
        assert (w_g, d_g) == (w_s, d_s)


# --------------------------------------------------------- MLP windows
def plain_window_tick(win, t, parks):
    """`closed_body`: expire every slot due by t (phase 0), then park each
    read return in the core's first free slot, slot 0 when none is free
    (argmax of `comp_t == PAD`), in channel order."""
    n_exp = sum(1 for x in win if x <= t)
    win = [PAD if x <= t else x for x in win]
    for done in parks:
        free = [k for k, x in enumerate(win) if x == PAD]
        win[free[0] if free else 0] = done
    return win, n_exp


class SummarizedWindow:
    """The kernel's window: slots plus `ret_min` (no return before it)
    and `ret_free` (first free slot, K for none); phase 0 walks the slots
    only when `ret_min <= t`, parking starts at `ret_free` and walks on
    to the next free slot."""

    def __init__(self, K):
        self.win, self.ret_min, self.ret_free, self.K = [PAD] * K, PAD, 0, K

    def tick(self, t, parks):
        n_exp = 0
        if self.ret_min <= t:
            lo, first = PAD, self.K
            for k in range(self.K):
                if self.win[k] <= t:
                    self.win[k] = PAD
                    n_exp += 1
                if self.win[k] != PAD:
                    lo = min(lo, self.win[k])
                elif first == self.K:
                    first = k
            self.ret_min, self.ret_free = lo, first
        for done in parks:
            k = self.ret_free if self.ret_free < self.K else 0
            self.win[k] = done
            self.ret_min = min(self.ret_min, done)
            nxt = next((i for i in range(k + 1, self.K)
                        if self.win[i] == PAD), self.K)
            self.ret_free = nxt
        return n_exp


@pytest.mark.parametrize("case", ["random", "two_channels_one_core",
                                  "full_window", "one_slot"])
def test_window_summary_equals_first_free_slot(case):
    rs = np.random.RandomState(len(case))
    K = 1 if case == "one_slot" else 8
    plain, fast = [PAD] * K, SummarizedWindow(K)
    for t in range(3000):
        if case == "full_window":          # more parks than free slots
            parks = [t + int(rs.randint(1, 400))
                     for _ in range(int(rs.randint(0, 3)))]
        elif case == "two_channels_one_core":
            parks = [t + int(rs.randint(1, 30)) for _ in range(2)] \
                if rs.rand() < 0.4 else []
        else:
            parks = [t + int(rs.randint(1, 60))
                     for _ in range(int(rs.rand() < 0.5))]
        plain, n_plain = plain_window_tick(plain, t, parks)
        assert fast.tick(t, parks) == n_plain
        assert fast.win == plain
        # no return before `ret_min` (below the true minimum only after
        # a full window's slot 0 was overwritten); `ret_free` is exact
        assert fast.ret_min <= min(plain)
        assert fast.ret_free == next(
            (k for k, x in enumerate(plain) if x == PAD), K)


# ------------------------------------------------------------------ p99
def group_p99(hist, reads, max_lat, G):
    """`Machine::write_stats`: bins [0, max_lat] cut into G runs, a run a
    lane; an inclusive prefix sum over the lanes; the first lane whose
    sum reaches the target (`__ffs` of a ballot) walks its run."""
    out = []
    for h, r, ml in zip(hist.tolist(), reads.tolist(), max_lat.tolist()):
        target = (99 * r + 99) // 100
        bins = ml + 1
        run = -(-bins // G)
        parts = [sum(h[l * run:min((l + 1) * run, bins)]) for l in range(G)]
        incl = np.cumsum(parts)
        reached = [l for l in range(G) if incl[l] >= target]
        p99 = 0
        if reached:
            l = reached[0]
            cum = int(incl[l] - parts[l])
            for i in range(l * run, min((l + 1) * run, bins)):
                cum += h[i]
                if cum >= target:
                    p99 = i
                    break
        out.append(p99)
    return torch.tensor(out)


def _hists(case, n, seed):
    rs = np.random.RandomState(seed)
    nb = MAX_LAT_TICKS + 1
    hist = np.zeros((n, nb), np.int32)
    for i in range(n):
        if case == "no_reads":
            continue
        if case == "one_bin":
            hist[i, rs.randint(0, nb)] = rs.randint(1, 50)
        elif case == "capped":             # latencies at MAX_LAT_TICKS
            hist[i, MAX_LAT_TICKS] = rs.randint(1, 5)
            hist[i, rs.randint(0, 200, 20)] += 1
        else:
            lat = rs.geometric(0.02, rs.randint(1, 400)).clip(0, nb - 1)
            np.add.at(hist[i], lat, 1)
    return torch.from_numpy(hist)


@pytest.mark.parametrize("case", ["random", "one_bin", "capped",
                                  "no_reads"])
@pytest.mark.parametrize("G", [1, 8, 32])
def test_parallel_p99_equals_first_bin_reaching_target(case, G):
    hist = _hists(case, 40, seed=G)
    reads = hist.sum(dim=1).to(torch.int32)
    nz = hist > 0
    max_lat = torch.where(nz.any(1), (nz.to(I64) * torch.arange(
        hist.shape[1])).max(1).values, 0)
    out = {k: torch.zeros(hist.shape[0], dtype=torch.int32)
           for k in ("writes", "hits", "misses", "refpb", "refab",
                     "lat_sum", "maxlag", "last_done")}
    out.update(reads=reads, hist=hist)
    want = _pack_stats(out, torch.ones(hist.shape[0], dtype=torch.bool))
    assert want.shape[1] == MEGA_NSTAT
    assert torch.equal(group_p99(hist, reads, max_lat, G),
                       want[:, MS_P99].to(I64))


# --------------------------------------------------- refresh schedules
def sat_add(a, b):
    return INT_MAX if a > INT_MAX - b else a + b


@pytest.mark.parametrize("refi,phase", [(7, 0), (7, 5), (100, 350),
                                        (1 << 30, 3), (INT_MAX, 0)])
def test_incremental_due_count_equals_division(refi, phase):
    """`due = t >= phase ? (t - phase) / tREFI + 1 : 0`, counted as t
    passes each due tick (held at INT_MAX past the int32 range)."""
    due, nxt = 0, phase
    for t in range(0, 2000):
        while t >= nxt:
            due += 1
            nxt = sat_add(nxt, refi)
        assert due == ((t - phase) // refi + 1 if t >= phase else 0)


@pytest.mark.parametrize("refi,R,r", [(7, 1, 0), (40, 4, 3), (39, 5, 2),
                                      (1 << 30, 2, 1)])
def test_incremental_debt_ticks_equal_modulo(refi, R, r):
    """Rank r's all-bank debt accrues at t > rp with (t - rp) % tREFI ==
    0, rp = r * (tREFI / R): at `next_debt`, stepped by tREFI."""
    rp = r * (refi // R)
    nxt = sat_add(rp, refi)
    for t in range(0, 3000):
        fire = t == nxt
        if fire:
            nxt = sat_add(t, refi)
        assert fire == (t > rp and (t - rp) % refi == 0)
