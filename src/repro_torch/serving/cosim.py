"""Serving <-> DRAM co-simulation: replay KV page traffic through DramSim.

The continuous-batching `EngineCore` already treats the paged KV cache as
a DRAM analogue (page-group = bank, compression = refresh).  This module
closes the loop the other way: the page accesses each engine round
actually generates — every page a decode step gathers, every staged
token write — are streamed through the tick-driven `DramSim` as the
demand workload, under the *same* registry refresh policy the engine is
running.  The DRAM queueing stall of every access is then attributed
back to the request that caused it, so end-to-end serving metrics
(TTFT/TPOT in simulated ticks) reflect refresh interference exactly the
way Fig. 1 of the paper measures it for CPU workloads.

Pipeline (one `run_cosim` call):

  1. build `ServingArrivals` from the scenario registry and drive an
     `EngineCore` (cheap deterministic stub forwards, so thousands of
     requests are tractable) with `record_traffic=True`;
  2. lay engine rounds out on a tick clock — round r+1 starts
     ``max(base_round_ticks, n_events_r + 1)`` ticks after round r, and
     the round's accesses arrive one tick apart inside it;
  3. map each page access to DRAM coordinates (``bank = page %
     n_groups``, ``row = (page // n_groups) % n_rows``, ``subarray =
     row % n_subarrays``) and replay the whole stream as a single-core
     `TraceWorkload` through ``DramSim.run_ticks``;
  4. match serves back to accesses per (bank, is_write) FIFO — reads
     enter their bank queue at emission and writes drain from the write
     buffer in emission order, so the k-th serve of a class on a bank IS
     its k-th emitted access (the row echoed in the serve tuple
     cross-checks the match) — and charge ``serve_tick - queue_entry``
     to the owning request's ``RequestMetrics.dram_stall_ticks``.

Everything is deterministic per (scenario, seed, policy): summaries are
bit-identical across repeat runs (`bit_identical_replay` pins this).

No wall-clock times enter the summary — TTFT/TPOT are reported in
simulated ticks (and derived milliseconds via ``dt_ns``).

The engine's paged cache lives on `CoSimConfig.device` (the card by
default; ``"cpu"`` on request), so its page compressions run kernel D
there; the stub forwards stay numpy.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.refresh.scenarios import make_serving_arrivals
from repro_torch.core.refresh.sim import DramSim, SimResult
from repro_torch.core.refresh.timing import timing_for_density
from repro_torch.core.refresh.workload import trace_workload
from repro_torch.kvcache.paged import PagedKVConfig
from repro_torch.serving.engine import EngineConfig, EngineCore, QueueFull, \
    RequestState


class CoSimTimeout(RuntimeError):
    """The engine failed to drain within `CoSimConfig.max_rounds` —
    always raised, never folded into the summary as a soft flag."""


# ------------------------------------------------------------ stub model

def make_stub_forwards(n_layers: int, n_kv_heads: int, head_dim: int,
                       vocab: int = 64) -> Tuple[Callable, Callable]:
    """Deterministic, model-free (prefill_fn, decode_fn) with the real
    forward signatures. Decode emits one-hot logits of
    ``(tok*31 + seq_len*7 + 13) % vocab`` so the token stream — and with
    it the page traffic — is a pure function of the request stream."""
    L, H, D = int(n_layers), int(n_kv_heads), int(head_dim)

    def kv_of(tok: int) -> float:
        return ((tok % 7) - 3) * 0.25

    def prefill_fn(params, cfg, dims, cache, sids, chunks):
        B = len(chunks)
        T = max((len(c) for c in chunks), default=0)
        k = np.zeros((L, B, T, H, D), np.float32)
        for bi, ch in enumerate(chunks):
            for t, tok in enumerate(ch):
                k[:, bi, t] = kv_of(int(tok))
        return k, k.copy()

    def decode_fn(params, cfg, dims, cache, sids, toks):
        toks = np.asarray(toks.cpu())       # the engine's tokens tensor
        B = toks.shape[0]
        logits = np.zeros((B, vocab), np.float32)
        k = np.zeros((L, B, H, D), np.float32)
        for bi in range(B):
            tok = int(toks[bi])
            pos = int(cache.seq_len[sids[bi]])
            logits[bi, (tok * 31 + pos * 7 + 13) % vocab] = 1.0
            k[:, bi] = kv_of(tok)
        return logits, k, k.copy()

    return prefill_fn, decode_fn


# ----------------------------------------------------------------- config

@dataclass
class CoSimConfig:
    """One co-sim run: a serving scenario x one registry refresh policy
    (driving BOTH the engine's maintenance and the DRAM sim)."""
    scenario: str = "serving_bursty"
    policy: str = "darp"
    n_requests: int = 200
    seed: int = 0
    # --- DRAM side
    density_gb: int = 32          # 32 Gb: tRFC_ab 890 ns vs tRFC_pb 380 ns
    dt_ns: float = 6.0
    base_round_ticks: int = 32    # minimum tick span of one engine round
    n_rows: int = 4096
    # --- engine side (stub-model scale: thousands of requests are fine)
    max_batch: int = 16
    max_queue: int = 64
    prefill_chunk: int = 8
    arbitration: str = "fifo"
    ttft_slo_rounds: int = 0
    tpot_slo_rounds: int = 0
    max_rounds: int = 20_000
    vocab: int = 64
    # --- KV geometry; n_groups MUST equal the DRAM bank count
    page_size: int = 4
    n_pages: int = 256
    n_staging: int = 32
    n_groups: int = 8
    max_seqs: int = 32
    max_pages_per_seq: int = 16
    device: str = "cuda"          # where the engine's paged cache lives

    def kv_config(self) -> PagedKVConfig:
        return PagedKVConfig(
            n_layers=1, n_kv_heads=1, head_dim=4,
            page_size=self.page_size, n_pages=self.n_pages,
            n_staging=self.n_staging, n_groups=self.n_groups,
            max_seqs=self.max_seqs,
            max_pages_per_seq=self.max_pages_per_seq)


@dataclass
class CoSimRun:
    """Everything a test might want to poke at; `summary()` is the
    JSON-able, deterministic slice."""
    cfg: CoSimConfig
    engine: EngineCore
    handles: list
    events: list                  # (round, rid, page, is_write) as replayed
    arrival_ticks: np.ndarray     # nominal queue-entry tick per event
    round_ticks: np.ndarray       # tick each engine round starts at
    sim: Optional[SimResult]
    stream: Optional[dict]
    recon: dict
    ttft_ticks: Dict[int, int] = field(default_factory=dict)
    tpot_ticks: Dict[int, float] = field(default_factory=dict)

    def summary(self) -> dict:
        ms = self.cfg.dt_ns * 1e-6
        eng = self.engine

        def pct(xs, scale=1.0):
            if not xs:
                return {"p50": None, "p95": None, "p99": None}
            a = np.asarray(sorted(xs), np.float64) * scale
            return {"p50": round(float(np.percentile(a, 50)), 4),
                    "p95": round(float(np.percentile(a, 95)), 4),
                    "p99": round(float(np.percentile(a, 99)), 4)}

        ttfts = sorted(self.ttft_ticks.values())
        tpots = sorted(self.tpot_ticks.values())
        return {
            "scenario": self.cfg.scenario,
            "policy": self.cfg.policy,
            "n_requests": self.cfg.n_requests,
            "seed": self.cfg.seed,
            "rounds": eng.round,
            "completed": sum(1 for h in self.handles
                             if h.state is RequestState.DONE),
            "evicted": sum(1 for h in self.handles
                           if h.state is RequestState.EVICTED),
            "makespan_ticks": (round(float(self.sim.makespan), 1)
                               if self.sim is not None else 0.0),
            "ttft_ticks": pct(ttfts),
            "tpot_ticks": pct(tpots),
            "ttft_ms": pct(ttfts, ms),
            "tpot_ms": pct(tpots, ms),
            "dram_stall_ticks": int(sum(h.metrics.dram_stall_ticks
                                        for h in self.handles)),
            "engine": {
                "stall_rounds": eng.stats["stall_rounds"],
                "evictions": eng.stats["evictions"],
                "maintenance_events": len(eng.stats["maintenance_events"]),
                "compressions": int(eng.cache.stats["compressions"]),
                "forced": int(eng.cache.stats["forced"]),
            },
            "recon": dict(self.recon),
        }


# ------------------------------------------------------------- the driver

def _prompt_tokens(rid: int, n: int, vocab: int) -> List[int]:
    return [(rid * 13 + j * 7 + 1) % vocab for j in range(n)]


def _drive_engine(cfg: CoSimConfig) -> Tuple[EngineCore, list]:
    """Run the continuous-batching loop over the scenario's arrival
    trace; returns (engine, handles aligned with arrival order)."""
    arr = make_serving_arrivals(cfg.scenario, n_requests=cfg.n_requests,
                                seed=cfg.seed)
    pf, df = make_stub_forwards(1, 1, 4, vocab=cfg.vocab)
    ecfg = EngineConfig(
        max_batch=cfg.max_batch, max_queue=cfg.max_queue,
        policy=cfg.policy, prefill_chunk=cfg.prefill_chunk,
        arbitration=cfg.arbitration,
        ttft_slo_rounds=cfg.ttft_slo_rounds,
        tpot_slo_rounds=cfg.tpot_slo_rounds,
        record_traffic=True)
    eng = EngineCore(None, None, None, cfg.kv_config(), ecfg,
                     prefill_fn=pf, decode_fn=df, device=cfg.device)
    handles: List[Optional[object]] = [None] * len(arr)
    pending = list(range(len(arr)))      # arrival indices not yet admitted
    while pending or eng.has_work():
        if eng.round >= cfg.max_rounds:
            raise CoSimTimeout(
                f"co-sim engine did not drain within "
                f"{cfg.max_rounds} rounds ({len(pending)} arrivals "
                f"pending, queue={len(eng.queue)}, "
                f"active={len(eng.active)}) — scenario "
                f"{cfg.scenario!r}, {cfg.n_requests} requests")
        still = []
        for i in pending:
            if int(arr.arrive_round[i]) > eng.round:
                still.append(i)
                continue
            try:
                handles[i] = eng.submit(
                    _prompt_tokens(i, int(arr.prompt_len[i]), cfg.vocab),
                    max_new=int(arr.max_new[i]),
                    priority=int(arr.priority[i]))
            except QueueFull:
                still.append(i)          # backpressure: retry next round
        pending = still
        eng.step_round()
    return eng, handles


def _layout_ticks(cfg: CoSimConfig, eng: EngineCore):
    """Place rounds on the tick clock and every access within its round.
    Returns (round_ticks [rounds+1], arrival_ticks [n_events])."""
    n_rounds = eng.round
    per_round = np.zeros(n_rounds + 1, np.int64)
    for (r, _rid, _p, _w) in eng.traffic:
        per_round[r] += 1
    spans = np.maximum(cfg.base_round_ticks, per_round + 1)
    round_ticks = np.zeros(n_rounds + 2, np.int64)
    round_ticks[1:] = np.cumsum(spans)
    arrival = np.zeros(len(eng.traffic), np.int64)
    off = np.zeros(n_rounds + 1, np.int64)
    for i, (r, _rid, _p, _w) in enumerate(eng.traffic):
        arrival[i] = round_ticks[r] + off[r]
        off[r] += 1
    return round_ticks, arrival


def _build_stream(cfg: CoSimConfig, eng: EngineCore,
                  arrival: np.ndarray) -> dict:
    n = len(eng.traffic)
    bank = np.zeros(n, np.int64)
    row = np.zeros(n, np.int64)
    isw = np.zeros(n, bool)
    for i, (_r, _rid, page, w) in enumerate(eng.traffic):
        bank[i] = page % cfg.n_groups
        row[i] = (page // cfg.n_groups) % cfg.n_rows
        isw[i] = w
    timing = timing_for_density(cfg.density_gb)
    sub = row % timing.n_subarrays
    think = np.empty(n, np.int64)
    if n:
        think[0] = arrival[0]
        think[1:] = np.diff(arrival)
    return {"is_write": isw, "bank": bank, "row": row,
            "subarray": sub.astype(np.int64), "think_ticks": think}


def _attribute_stalls(cfg: CoSimConfig, eng: EngineCore, handles: list,
                      res: SimResult, round_ticks: np.ndarray) -> dict:
    """Per-(bank, is_write) FIFO match of serves back to accesses; charge
    stalls to requests and compute tick-space TTFT/TPOT. Returns the
    reconciliation dict (see `tests/test_serving_cosim.py`)."""
    fifo: Dict[Tuple[int, bool], List[int]] = {}
    for i, (_r, _rid, page, w) in enumerate(eng.traffic):
        fifo.setdefault((page % cfg.n_groups, bool(w)), []).append(i)
    heads = {k: 0 for k in fifo}
    by_rid = {h.rid: h for h in handles if h is not None}
    stall_pre: Dict[int, int] = {}       # rid -> stall before first token
    stall_post: Dict[int, int] = {}
    row_mismatches = 0
    serves = res.timeline["serves"]
    n_read_serves = n_write_serves = 0
    for (t, b, _sub, srow, sw, _done, arr_t) in serves:
        key = (int(b), bool(sw))
        q = fifo.get(key, [])
        k = heads.get(key, 0)
        if k >= len(q):
            row_mismatches += 1          # serve with no matching access
            continue
        heads[key] = k + 1
        ei = q[k]
        r, rid, page, _w = eng.traffic[ei]
        if int(srow) != (page // cfg.n_groups) % cfg.n_rows:
            row_mismatches += 1
        stall = max(0, int(t) - int(arr_t))
        if sw:
            n_write_serves += 1
        else:
            n_read_serves += 1
        h = by_rid.get(rid)
        if h is None:
            continue
        h.metrics.dram_stall_ticks += stall
        if (h.metrics.first_token_round < 0
                or r <= h.metrics.first_token_round):
            stall_pre[rid] = stall_pre.get(rid, 0) + stall
        else:
            stall_post[rid] = stall_post.get(rid, 0) + stall
    unmatched = sum(len(q) - heads[k] for k, q in fifo.items())
    unmatched_reads = sum(len(q) - heads[k]
                          for k, q in fifo.items() if not k[1])
    ttft_ticks, tpot_ticks = {}, {}
    for h in handles:
        if h is None or h.state is not RequestState.DONE:
            continue
        m = h.metrics
        if m.first_token_round >= 0:
            ttft_ticks[h.rid] = int(
                round_ticks[m.first_token_round + 1]
                - round_ticks[m.submit_round]
                + stall_pre.get(h.rid, 0))
        if m.finish_round > m.first_token_round >= 0 and len(h.tokens) > 1:
            tpot_ticks[h.rid] = (
                float(round_ticks[m.finish_round]
                      - round_ticks[m.first_token_round + 1]
                      + stall_post.get(h.rid, 0))
                / (len(h.tokens) - 1))
    n_reads = sum(1 for (_r, _i, _p, w) in eng.traffic if not w)
    n_writes = len(eng.traffic) - n_reads
    recon = {
        "emitted_reads": n_reads,
        "emitted_writes": n_writes,
        "reads_done": int(res.reads_done),
        "writes_done": int(res.writes_done),
        "serve_reads": n_read_serves,
        "serve_writes": n_write_serves,
        "row_mismatches": row_mismatches,
        "unmatched_accesses": int(unmatched),
        "unmatched_reads": int(unmatched_reads),
        "max_abs_lag": int(res.max_abs_lag),
        "cmd_counts": (dict(res.commands.counts())
                       if res.commands is not None else None),
    }
    return recon, ttft_ticks, tpot_ticks


def run_cosim(cfg: CoSimConfig) -> CoSimRun:
    """Full co-sim pass (engine drive -> tick layout -> DRAM replay ->
    stall attribution). Raises `CoSimTimeout` if the serving loop cannot
    drain — never returns a silently-truncated run."""
    timing = timing_for_density(cfg.density_gb)
    if timing.n_banks_total != cfg.n_groups:
        raise ValueError(
            f"KV n_groups ({cfg.n_groups}) must equal the DRAM bank "
            f"count ({timing.n_banks_total}) for the page-group <-> "
            f"bank mapping to be a bijection")
    eng, handles = _drive_engine(cfg)
    round_ticks, arrival = _layout_ticks(cfg, eng)
    if not eng.traffic:
        return CoSimRun(cfg, eng, handles, [], arrival, round_ticks,
                        None, None, recon={"emitted_reads": 0,
                                           "emitted_writes": 0})
    stream = _build_stream(cfg, eng, arrival)
    tw = trace_workload(f"cosim_{cfg.scenario}", stream, dt_ns=cfg.dt_ns)
    sim = DramSim(timing, tw, cfg.policy)
    res = sim.run_ticks(dt_ns=cfg.dt_ns, record_timeline=True,
                        record_commands=True)
    recon, ttft, tpot = _attribute_stalls(cfg, eng, handles, res,
                                          round_ticks)
    return CoSimRun(cfg, eng, handles, list(eng.traffic), arrival,
                    round_ticks, res, stream, recon,
                    ttft_ticks=ttft, tpot_ticks=tpot)


def compare_policies(policies, **cfg_kw) -> Dict[str, dict]:
    """Run the same scenario under each policy; returns name -> summary."""
    out = {}
    for name in policies:
        out[name] = run_cosim(CoSimConfig(policy=name, **cfg_kw)).summary()
    return out


def bit_identical_replay(cfg: CoSimConfig) -> bool:
    """True iff two independent runs of `cfg` produce byte-identical
    summaries (the determinism pin CI records per benchmark run)."""
    a = json.dumps(run_cosim(cfg).summary(), sort_keys=True)
    b = json.dumps(run_cosim(cfg).summary(), sort_keys=True)
    return a == b


# -------------------------------------------------------------------- CLI

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serving <-> DRAM co-sim smoke runner")
    ap.add_argument("--scenario", default="serving_bursty")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policies", default="darp,all_bank",
                    help="comma-separated registry policy names")
    ap.add_argument("--check-identical", action="store_true",
                    help="also run the first policy twice and require "
                         "bit-identical summaries")
    ap.add_argument("--device", default="cuda",
                    help="where the paged cache lives (cpu on request)")
    args = ap.parse_args(argv)
    policies = [p for p in args.policies.split(",") if p]
    out = compare_policies(policies, scenario=args.scenario,
                           n_requests=args.requests, seed=args.seed,
                           device=args.device)
    if args.check_identical:
        out["bit_identical"] = bit_identical_replay(
            CoSimConfig(policy=policies[0], scenario=args.scenario,
                        n_requests=args.requests, seed=args.seed,
                        device=args.device))
        if not out["bit_identical"]:
            print(json.dumps(out, indent=1))
            return 1
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
