"""Request-lifecycle serving engine (`EngineCore`) with refresh-aware KV
maintenance — the production API over the paged int8 cache.

Every request moves through an explicit lifecycle:

    QUEUED --admit--> PREFILL --last chunk--> DECODE --max_new--> DONE
       |                 \\______________________/
       |                      page exhaustion --> EVICTED
       '-- bounded queue full --> QueueFull raised at submit()

Per engine round (`step_round`):
  1. **admit**   queued requests into free batch slots (continuous
     batching; the admission queue is bounded — `submit()` raises
     `QueueFull` as the backpressure signal),
  2. **prefill** one chunk of prompt tokens for every PREFILL request in a
     single batched `paged_prefill_forward` call (NOT one forward call per
     prompt token),
  3. **decode**  one `paged_decode_forward` step for all DECODE sequences,
     appending the new K/V (the "write" phase) and streaming each sampled
     token through the request handle's callback,
  4. **maintenance window**: build a serving-side `MaintenanceView` —
     demand = page-groups the batch is attending to (the bank analogue),
     pressure = staging occupancy (the write-buffer analogue, which also
     gates the write-drain `write_window` signal) — and let the registry
     policy pick which page-groups to compress, recorded against the
     shared `MaintenanceLedger`. When pressure hits the red-line the
     engine force-compresses (the paper's budget-exhausted forced
     refresh),
  5. **retire**  finished requests (single O(n) pass), releasing pages.

Policies resolve by `repro_torch.core.policy` registry name — the same objects
the DRAM timing simulator runs ("all_bank", "round_robin", "darp", plus
registry extras like "elastic" and "hira"); `EngineConfig(policy="darp")`.

`submit()` returns a `RequestHandle` carrying the streamed tokens and
per-request metrics (TTFT, TPOT, stall/maintenance attribution). The
legacy `ServingEngine`/`ServeConfig`/`Request` spellings remain as a thin
deprecation shim at the bottom of this module.

Port of `repro/serving/engine.py`: the engine and its paged cache live on
one device — the params' device, or with no params (stub forwards) the
`device` argument, the card unless the caller asks for the CPU. Each
round's next tokens are a tensor there; the argmax comes back to the host
as numpy.
"""
from __future__ import annotations

import enum
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.policy import MaintenanceLedger, RefreshPolicy, resolve_policy
from repro_torch.kvcache import PagedKVCache, PagedKVConfig
from repro_torch.models.dims import Dims
from repro_torch.serving.paged_decode import (paged_decode_forward,
                                        paged_prefill_forward)


class RequestState(str, enum.Enum):
    QUEUED = "queued"      # submitted, waiting for a batch slot
    PREFILL = "prefill"    # admitted; prompt K/V being built chunk by chunk
    DECODE = "decode"      # generating tokens
    DONE = "done"          # produced max_new tokens (or had nothing to do)
    EVICTED = "evicted"    # killed to free pages under exhaustion


class QueueFull(RuntimeError):
    """Backpressure signal: the bounded admission queue is at capacity.
    Callers should drain (`step_round`) or shed load and retry."""


@dataclass
class RequestMetrics:
    """Per-request timings (wall-clock seconds + engine rounds) and
    stall/maintenance attribution. -1.0 / -1 mean "not reached yet"."""
    submit_time: float = -1.0
    admit_time: float = -1.0
    first_token_time: float = -1.0
    finish_time: float = -1.0
    submit_round: int = -1
    admit_round: int = -1
    first_token_round: int = -1
    finish_round: int = -1
    prefill_chunks: int = 0       # batched prefill rounds this request rode
    stall_rounds: int = 0         # rounds a forced compression stalled it
    maintenance_rounds: int = 0   # rounds scheduled maintenance overlapped it
    dram_stall_ticks: int = 0     # DRAM queueing ticks the co-sim attributed
    #   to this request's KV page traffic (serve_start - arrival, summed
    #   over its accesses; 0 outside a `repro_torch.serving.cosim` run)


@dataclass
class RequestHandle:
    """What `EngineCore.submit` returns: live request state, the token
    stream so far, and metrics. `on_token(handle, token)` fires as each
    token is produced (streaming)."""
    rid: int
    prompt: list
    max_new: int
    state: RequestState = RequestState.QUEUED
    tokens: list = field(default_factory=list)
    metrics: RequestMetrics = field(default_factory=RequestMetrics)
    on_token: Optional[Callable[["RequestHandle", int], None]] = None
    sid: int = -1
    priority: int = 0    # admission class, lower admits first ("priority"
    #                      arbitration only; FIFO ignores it)
    _next: int = -1      # next token to feed the decode step
    _pf_pos: int = 0     # prompt tokens already prefilled

    @property
    def done(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.EVICTED)

    @property
    def ttft(self) -> float:
        """Time-to-first-token in seconds (nan until the first token)."""
        m = self.metrics
        if m.first_token_time < 0:
            return float("nan")
        return m.first_token_time - m.submit_time

    @property
    def tpot(self) -> float:
        """Mean time-per-output-token after the first, in seconds (nan
        until two tokens exist)."""
        m = self.metrics
        if m.finish_time < 0 or m.first_token_time < 0 or len(self.tokens) < 2:
            return float("nan")
        return (m.finish_time - m.first_token_time) / (len(self.tokens) - 1)


@dataclass
class EngineConfig:
    max_batch: int = 4                 # concurrent PREFILL+DECODE requests
    max_queue: int = 64                # bounded admission queue (backpressure)
    policy: Union[str, enum.Enum, RefreshPolicy] = "darp"
    refresh_interval: float = 4.0      # rounds between group maintenance
    budget: int = 8                    # JEDEC-style postpone/pull-in budget
    max_compress_per_round: int = 1
    force_threshold: float = 0.75      # staging pressure red-line
    drain_threshold: float = 0.0       # pressure at/above which a round
    #   counts as a write-drain window (WRP pull-in); 0.0 = every write
    #   phase, matching the legacy engine
    prefill_chunk: int = 8             # prompt tokens per prefill round
    arbitration: str = "fifo"          # admission order: "fifo" (submit
    #   order) | "priority" (lowest RequestHandle.priority first, FIFO
    #   within a class — a stable scan, so equal priorities never reorder)
    ttft_slo_rounds: int = 0           # TTFT deadline in engine rounds
    tpot_slo_rounds: int = 0           # per-token deadline in rounds; with
    #   either SLO > 0 the maintenance view carries `slo_pressure` = the
    #   fraction of live requests out of headroom, so registry policies
    #   can defer refreshes under deadline waves. 0/0 disables (inert).
    record_traffic: bool = False       # append per-round KV page accesses
    #   to EngineCore.traffic as (round, rid, page, is_write) — the
    #   demand stream `repro_torch.serving.cosim` replays through DramSim


class EngineCore:
    """Continuous-batching engine with an explicit request lifecycle.

    The maintenance hot path resolves the policy from the registry and
    drives it through the shared `MaintenanceLedger` directly — no
    `DarpScheduler` involved.
    """

    def __init__(self, params, cfg, dims: Dims, kv_cfg: PagedKVConfig,
                 ecfg: Optional[EngineConfig] = None, *,
                 prefill_fn: Optional[Callable] = None,
                 decode_fn: Optional[Callable] = None, device=None, **kw):
        self.params = params
        self.cfg = cfg
        self.dims = dims
        if device is None:
            device = (params["embed"].device if params is not None
                      else "cuda")
        self.device = torch.device(device)
        self.cache = PagedKVCache(kv_cfg, device=self.device)
        self.ecfg = ecfg if ecfg is not None else EngineConfig(**kw)
        # pluggable forwards: the co-sim swaps in cheap deterministic
        # stubs (same signatures) so the event loop scales to thousands
        # of requests; params/cfg/dims may then be None
        self._prefill_fn = (prefill_fn if prefill_fn is not None
                            else paged_prefill_forward)
        self._decode_fn = (decode_fn if decode_fn is not None
                           else paged_decode_forward)
        self.policy: RefreshPolicy = resolve_policy(self.ecfg.policy)
        self.ledger = MaintenanceLedger(
            kv_cfg.n_groups, self.ecfg.refresh_interval,
            budget=self.ecfg.budget)
        self.queue: deque[RequestHandle] = deque()
        self.active: list[RequestHandle] = []
        self.finished: list[RequestHandle] = []
        self.round = 0
        self._rid = 0
        self._stalled_this_round = False
        self._inflight_prefill: set = set()   # rids mid-prefill-chunk
        #: (round, rid, page, is_write) per KV page access, recorded when
        #: `EngineConfig.record_traffic` — the co-sim's demand stream
        self.traffic: list = []
        self.stats = {"rounds": 0, "tokens": 0, "stall_rounds": 0,
                      "maintenance_events": [], "prefill_calls": 0,
                      "decode_calls": 0, "evictions": 0, "rejected": 0,
                      "timed_out": False}

    # --------------------------------------------------------------- submit
    def submit(self, prompt, max_new: int = 16, *, rid: Optional[int] = None,
               on_token: Optional[Callable] = None,
               priority: int = 0) -> RequestHandle:
        """Enqueue a request; returns its handle immediately.

        Raises `QueueFull` when the bounded queue is at capacity — the
        backpressure signal (the rejection is also counted in
        `stats["rejected"]`). Requests with nothing to do (empty prompt or
        `max_new <= 0`) finish as DONE on the spot. `priority` (lower =
        more urgent) only matters under `arbitration="priority"`.
        """
        if rid is None:
            rid = self._rid
        self._rid = max(self._rid, rid) + 1
        h = RequestHandle(rid=rid, prompt=list(prompt),
                          max_new=int(max_new), on_token=on_token,
                          priority=int(priority))
        h.metrics.submit_time = time.perf_counter()
        h.metrics.submit_round = self.round
        if not h.prompt or h.max_new <= 0:
            self._finish(h, RequestState.DONE)
            return h
        if len(self.queue) >= self.ecfg.max_queue:
            self.stats["rejected"] += 1
            raise QueueFull(
                f"admission queue at capacity ({self.ecfg.max_queue}); "
                f"drain with step_round() or shed load")
        self.queue.append(h)
        return h

    def would_block(self) -> bool:
        """True when the next `submit()` would raise `QueueFull`."""
        return len(self.queue) >= self.ecfg.max_queue

    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    # ---------------------------------------------------------------- admit
    def _next_admit(self) -> RequestHandle:
        """Pop the next request per the configured arbitration: FIFO pops
        the queue head; priority scans for the lowest (priority, submit
        order) pair — a stable min, so FIFO order survives inside each
        priority class and no class ever starves another *within* the
        bounded queue (admission pressure is bounded by `max_queue`)."""
        if self.ecfg.arbitration == "priority":
            i = min(range(len(self.queue)),
                    key=lambda j: (self.queue[j].priority, j))
            h = self.queue[i]
            del self.queue[i]
            return h
        return self.queue.popleft()

    def _admit(self) -> None:
        free_slots = int(self.cache.cfg.max_seqs - self.cache.active.sum())
        while (self.queue and free_slots > 0
               and len(self.active) < self.ecfg.max_batch):
            h = self._next_admit()
            h.sid = self.cache.new_seq()
            free_slots -= 1
            h.metrics.admit_time = time.perf_counter()
            h.metrics.admit_round = self.round
            if len(h.prompt) > 1:
                h.state = RequestState.PREFILL
            else:                       # single-token prompt: nothing to
                h.state = RequestState.DECODE        # prefill, decode away
                h._pf_pos = 0
                h._next = h.prompt[-1]
            self.active.append(h)

    # -------------------------------------------------------------- prefill
    def _prefill_round(self) -> None:
        """One chunk of prompt tokens for EVERY prefilling request, in a
        single batched forward call. The last prompt token is never
        prefilled — it is the first decode input, exactly like the legacy
        token-at-a-time engine."""
        pf = [h for h in self.active if h.state is RequestState.PREFILL]
        if not pf:
            return
        chunk = self.ecfg.prefill_chunk
        chunks = [h.prompt[h._pf_pos:
                           min(h._pf_pos + chunk, len(h.prompt) - 1)]
                  for h in pf]
        if self.ecfg.record_traffic:
            # chunked prefill re-gathers the WHOLE past context each
            # chunk: every existing page is read before the new K/V lands
            for h in pf:
                for p in self.cache.pages_of(h.sid):
                    self.traffic.append((self.round, h.rid, p, False))
        k_new, v_new = self._prefill_fn(
            self.params, self.cfg, self.dims, self.cache,
            [h.sid for h in pf], chunks)
        self.stats["prefill_calls"] += 1
        # while this batch's appends run, none of its members may be
        # picked as an eviction victim: a victim mid-chunk would leave
        # the k_new/v_new slices half-applied (the scheduler property
        # "eviction never selects an in-flight prefill chunk")
        self._inflight_prefill = {h.rid for h in pf}
        try:
            for bi, h in enumerate(pf):
                for t in range(len(chunks[bi])):
                    if h.state is not RequestState.PREFILL:
                        break           # evicted mid-append (as a victim)
                    if not self._append_or_evict(h, k_new[:, bi, t],
                                                 v_new[:, bi, t]):
                        break
                    if self.ecfg.record_traffic:
                        self.traffic.append(
                            (self.round, h.rid,
                             self.cache.pages_of(h.sid)[-1], True))
                if h.state is not RequestState.PREFILL:
                    continue
                h._pf_pos += len(chunks[bi])
                h.metrics.prefill_chunks += 1
                if h._pf_pos >= len(h.prompt) - 1:
                    h.state = RequestState.DECODE
                    h._next = h.prompt[-1]
        finally:
            self._inflight_prefill = set()

    # --------------------------------------------------------------- decode
    def _decode_round(self) -> int:
        dec = [h for h in self.active if h.state is RequestState.DECODE]
        if not dec:
            return 0
        sids = [h.sid for h in dec]
        toks = torch.tensor([h._next for h in dec], dtype=torch.int32,
                            device=self.device)
        if self.ecfg.record_traffic:
            # paged attention gathers every page of the sequence per step
            for h in dec:
                for p in self.cache.pages_of(h.sid):
                    self.traffic.append((self.round, h.rid, p, False))
        logits, k_new, v_new = self._decode_fn(
            self.params, self.cfg, self.dims, self.cache, sids, toks)
        self.stats["decode_calls"] += 1
        nxt = torch.argmax(torch.as_tensor(logits), -1).cpu().numpy()
        made = 0
        for bi, h in enumerate(dec):
            if h.state is not RequestState.DECODE:
                continue                # evicted mid-round (as a victim)
            if not self._append_or_evict(h, k_new[:, bi], v_new[:, bi]):
                continue
            if self.ecfg.record_traffic:
                self.traffic.append(
                    (self.round, h.rid,
                     self.cache.pages_of(h.sid)[-1], True))
            tok = int(nxt[bi])
            h.tokens.append(tok)
            h._next = tok
            made += 1
            if h.metrics.first_token_time < 0:
                h.metrics.first_token_time = time.perf_counter()
                h.metrics.first_token_round = self.round
            if h.on_token is not None:
                h.on_token(h, tok)
        self.stats["tokens"] += made
        return made

    # ------------------------------------------------- allocation pressure
    def _append_or_evict(self, h: RequestHandle, k_tok, v_tok) -> bool:
        """Append one token's K/V; on allocation failure, force-compress
        and then evict victims (newest first) until the append fits. If
        the request itself ends up the only candidate, IT is evicted —
        returns False in that case."""
        if self.cache.append(h.sid, k_tok, v_tok):
            return True
        self._force_compress()
        while True:
            if self.cache.append(h.sid, k_tok, v_tok):
                return True
            victim = self._pick_victim(exclude=h)
            if victim is None:
                self._evict(h)
                return False
            self._evict(victim)

    def _pick_victim(self, exclude: RequestHandle) -> Optional[RequestHandle]:
        """Newest admitted request (least progress lost) other than
        `exclude`. Members of the prefill batch currently applying a
        chunk are never selected — their K/V slices are mid-flight and
        evicting one would leave the chunk half-applied."""
        for h in reversed(self.active):
            if (h is not exclude
                    and h.rid not in self._inflight_prefill
                    and h.state in (RequestState.PREFILL,
                                    RequestState.DECODE)):
                return h
        return None

    def _evict(self, h: RequestHandle) -> None:
        self.cache.release_seq(h.sid)
        self.stats["evictions"] += 1
        self._finish(h, RequestState.EVICTED)

    def _force_compress(self) -> None:
        """Stop-the-world compression (pressure red-line / failed alloc) —
        the paper's budget-exhausted forced refresh. Counted at most once
        per round no matter how many triggers fire."""
        for p in self.cache.compressible_pages():
            self.cache.compress_page(p, forced=True)
        if not self._stalled_this_round:
            self._stalled_this_round = True
            self.stats["stall_rounds"] += 1
            for h in self.active:
                if not h.done:
                    h.metrics.stall_rounds += 1

    # ---------------------------------------------------------- maintenance
    def _slo_pressure(self) -> float:
        """Fraction of live requests whose SLO headroom is exhausted:
        PREFILL/QUEUED-age past `ttft_slo_rounds` without a first token,
        or a decode running slower than `tpot_slo_rounds` rounds/token.
        0.0 whenever the SLO knobs are unset (legacy engines)."""
        ttft = self.ecfg.ttft_slo_rounds
        tpot = self.ecfg.tpot_slo_rounds
        if ttft <= 0 and tpot <= 0:
            return 0.0
        live = [h for h in self.active if not h.done]
        if not live:
            return 0.0
        late = 0
        for h in live:
            waited = self.round - h.metrics.submit_round
            if h.metrics.first_token_round < 0:
                if ttft > 0 and waited >= ttft:
                    late += 1
            elif tpot > 0 and h.tokens:
                per_tok = (self.round - h.metrics.first_token_round) \
                    / max(1, len(h.tokens))
                if per_tok >= tpot:
                    late += 1
        return late / len(live)

    def _maintenance(self) -> None:
        """The serving-side maintenance window: map engine state onto a
        `MaintenanceView` (demand = attended page-groups, pressure =
        staging occupancy standing in for the write-buffer level) and let
        the registry policy decide which groups to compress."""
        pressure = self.cache.staging_pressure()
        if pressure >= self.ecfg.force_threshold:
            self._force_compress()
            return
        if getattr(self.policy, "ideal", False):
            return
        # demand = pages the batch is reading: decoding sequences camp on
        # their newest pages; prefilling sequences re-gather their WHOLE
        # past every chunk, so all their pages count — compressing one
        # mid-prefill would degrade every remaining chunk's reads
        attending = []
        for h in self.active:
            if h.state is RequestState.DECODE:
                attending += self.cache.pages_of(h.sid)[-2:]
            elif h.state is RequestState.PREFILL:
                attending += self.cache.pages_of(h.sid)
        demand = self.cache.demand_by_group(attending)
        view = self.ledger.view(
            float(self.round), demand=demand,
            ready=self.cache.group_ready(),
            idle=[d == 0 for d in demand],
            write_window=pressure >= self.ecfg.drain_threshold,
            max_issues=self.ecfg.max_compress_per_round,
            pressure=pressure,
            slo_pressure=self._slo_pressure())
        decisions = self.policy.select(view)
        groups = self.ledger.apply(decisions, float(self.round))
        if not groups:
            return
        pages = 0
        for g in groups:
            pages += self.cache.compress_group(g)
        self.stats["maintenance_events"].append(
            {"round": self.round, "groups": groups, "pages": pages,
             "forced": any(d.forced for d in decisions)})
        for h in self.active:
            if not h.done:
                h.metrics.maintenance_rounds += 1

    # --------------------------------------------------------------- retire
    def _retire(self) -> None:
        for h in self.active:
            if (h.state is RequestState.DECODE
                    and len(h.tokens) >= h.max_new):
                self.cache.release_seq(h.sid)
                self._finish(h, RequestState.DONE)
        # single O(n) rebuild — never .remove() inside a scan
        self.active = [h for h in self.active if not h.done]

    def _finish(self, h: RequestHandle, state: RequestState) -> None:
        h.state = state
        h.metrics.finish_time = time.perf_counter()
        h.metrics.finish_round = self.round
        self.finished.append(h)

    # ------------------------------------------------------------------ run
    def step_round(self) -> int:
        """One engine round (admit → prefill → decode → maintenance →
        retire). Returns decode tokens produced."""
        self._stalled_this_round = False
        self._admit()
        self._prefill_round()
        made = self._decode_round()
        self._maintenance()
        self._retire()
        self.round += 1
        self.stats["rounds"] += 1
        return made

    def run_until_done(self, max_rounds: int = 10_000) -> dict:
        """Drive rounds until all work drains. Hitting `max_rounds` with
        requests still pending records `stats["timed_out"] = True` and
        warns — it is never silently masked as success."""
        r = 0
        while self.has_work() and r < max_rounds:
            self.step_round()
            r += 1
        self.stats["timed_out"] = self.has_work()
        if self.stats["timed_out"]:
            warnings.warn(
                f"run_until_done stopped at max_rounds={max_rounds} with "
                f"{len(self.queue)} queued / {len(self.active)} active "
                f"requests still pending (livelock or undersized budget)",
                RuntimeWarning, stacklevel=2)
        return self.stats

    # -------------------------------------------------------------- metrics
    def metrics_summary(self) -> dict:
        """Aggregate TTFT/TPOT percentiles (milliseconds) plus lifecycle
        counts over every finished request."""
        done = [h for h in self.finished if h.state is RequestState.DONE]
        ttfts = [h.ttft for h in done if np.isfinite(h.ttft)]
        tpots = [h.tpot for h in done if np.isfinite(h.tpot)]

        def pct(xs):
            if not xs:
                return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
            a = np.asarray(xs) * 1e3
            return {"p50_ms": round(float(np.percentile(a, 50)), 3),
                    "p95_ms": round(float(np.percentile(a, 95)), 3),
                    "p99_ms": round(float(np.percentile(a, 99)), 3)}

        return {
            "completed": len(done),
            "evicted": sum(1 for h in self.finished
                           if h.state is RequestState.EVICTED),
            "ttft": pct(ttfts),
            "tpot": pct(tpots),
            "stall_rounds": self.stats["stall_rounds"],
            "dram_stall_ticks": sum(h.metrics.dram_stall_ticks
                                    for h in self.finished),
            "prefill_calls": self.stats["prefill_calls"],
            "decode_calls": self.stats["decode_calls"],
            "maintenance_events": len(self.stats["maintenance_events"]),
        }


# ========================================================================
# Legacy shim — the pre-lifecycle API, kept working for old callers.
# ========================================================================

@dataclass
class Request:
    """Legacy request record (pre-`RequestHandle`). `out` still receives
    the generated tokens, streamed from the underlying handle."""
    prompt: list
    max_new: int = 16
    rid: int = 0
    out: list = field(default_factory=list)
    sid: int = -1
    done: bool = False
    _next: int = -1
    _handle: Optional[RequestHandle] = None


@dataclass
class ServeConfig:
    """Legacy config spelling; `EngineConfig` supersedes it."""
    max_batch: int = 4
    policy: Union[str, enum.Enum, RefreshPolicy] = "darp"
    refresh_interval: float = 4.0
    budget: int = 8
    max_compress_per_round: int = 1
    force_threshold: float = 0.75


class ServingEngine:
    """Deprecated compatibility wrapper: the old synchronous reference API
    mapped onto `EngineCore`. The queue is effectively unbounded and every
    write phase counts as a drain window, matching historical behavior."""

    def __init__(self, params, cfg, dims: Dims, kv_cfg: PagedKVConfig,
                 serve_cfg: ServeConfig):
        warnings.warn(
            "ServingEngine/ServeConfig are deprecated; use "
            "repro_torch.serving.EngineCore / EngineConfig",
            DeprecationWarning, stacklevel=2)
        self.scfg = serve_cfg
        self.core = EngineCore(params, cfg, dims, kv_cfg, EngineConfig(
            max_batch=serve_cfg.max_batch,
            policy=serve_cfg.policy,
            refresh_interval=serve_cfg.refresh_interval,
            budget=serve_cfg.budget,
            max_compress_per_round=serve_cfg.max_compress_per_round,
            force_threshold=serve_cfg.force_threshold,
            max_queue=1 << 30,          # legacy queue was unbounded
            drain_threshold=0.0))
        self._reqs: list[Request] = []

    # legacy attribute surface -------------------------------------------
    @property
    def cache(self) -> PagedKVCache:
        return self.core.cache

    @property
    def stats(self) -> dict:
        return self.core.stats

    @property
    def round(self) -> int:
        return self.core.round

    @property
    def queue(self) -> list:
        """Legacy Request records still waiting for admission."""
        return [r for r in self._reqs
                if r._handle is not None
                and r._handle.state is RequestState.QUEUED]

    @property
    def active(self) -> list:
        """Legacy Request records currently prefilling/decoding."""
        return [r for r in self._reqs
                if r._handle is not None
                and r._handle.state in (RequestState.PREFILL,
                                        RequestState.DECODE)]

    # legacy call surface -------------------------------------------------
    def submit(self, req: Request) -> None:
        h = self.core.submit(req.prompt, req.max_new, rid=req.rid,
                             on_token=lambda _h, tok: req.out.append(tok))
        req._handle = h
        req.done = h.done
        self._reqs.append(req)

    def step_round(self) -> int:
        made = self.core.step_round()
        self._sync()
        return made

    def run_until_done(self, max_rounds: int = 10_000) -> None:
        self.core.run_until_done(max_rounds=max_rounds)
        self._sync()

    def _sync(self) -> None:
        for r in self._reqs:
            if r._handle is not None:
                r.done = r._handle.done
                r.sid = r._handle.sid
