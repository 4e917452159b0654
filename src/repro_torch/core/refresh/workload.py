"""Closed-loop multi-core workload generator for the DRAM simulator.

Each core is a limited-MLP request engine: up to `mlp` outstanding memory
requests; after a request completes, the core 'computes' for think_ns before
issuing the next. Address streams have tunable row locality and write ratio,
deterministic per seed.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

#: One legacy generator a thread, reseeded at each draw: building a
#: `RandomState` first seeds it from OS entropy, which costs more than a
#: core's draws; `seed(s)` gives the same stream as `RandomState(s)`.
_rng = threading.local()


def _seeded(seed) -> np.random.RandomState:
    rs = getattr(_rng, "rs", None)
    if rs is None:
        rs = _rng.rs = np.random.RandomState()
    rs.seed(seed)
    return rs


@dataclass(frozen=True)
class Workload:
    name: str
    n_cores: int
    mlp: int                      # max outstanding requests per core
    think_ns: float               # mean compute gap between requests
    row_hit_rate: float
    write_ratio: float
    reqs_per_core: int
    seed: int = 0

    def generate(self, n_banks: int, n_subarrays: int, n_rows: int = 4096):
        """Per-core request streams: dicts of (is_write, bank, row,
        subarray, think_ns) arrays, each a row of `_draw`'s planes."""
        p = self._draw(n_banks, n_subarrays, n_rows)
        return [{k: v[c] for k, v in p.items()} for c in range(self.n_cores)]

    def _draw(self, n_banks: int, n_subarrays: int, n_rows: int = 4096):
        """Every core's stream as [n_cores, reqs_per_core] planes: is_write
        bool, bank/row/subarray int64, think (ns) float64. One stream per
        seed, drawn core by core (rand, randint, randint, rand,
        exponential); with prob row_hit_rate a request reuses its core's
        previous (bank, row), request 0 never."""
        rs = _seeded(self.seed)
        C, n = self.n_cores, self.reqs_per_core
        is_write = np.empty((C, n), bool)
        bank = np.empty((C, n), np.int64)
        row = np.empty((C, n), np.int64)
        reuse = np.empty((C, n), bool)
        think = np.empty((C, n), np.float64)
        for c in range(C):
            is_write[c] = rs.rand(n) < self.write_ratio
            bank[c] = rs.randint(0, n_banks, n)
            row[c] = rs.randint(0, n_rows, n)
            reuse[c] = rs.rand(n) < self.row_hit_rate
            think[c] = rs.exponential(self.think_ns, n)
        # row locality: a request takes the (bank, row) of the last request
        # at or before it that drew its own (a forward fill of indices;
        # request 0 is index 0 whatever it drew)
        src = np.where(reuse, 0, np.arange(n))
        np.maximum.accumulate(src, axis=1, out=src)
        bank = np.take_along_axis(bank, src, axis=1)
        row = np.take_along_axis(row, src, axis=1)
        return dict(is_write=is_write, bank=bank, row=row,
                    subarray=row % n_subarrays, think=think)


@dataclass(frozen=True)
class TraceWorkload(Workload):
    """Single-core workload replaying an explicit pre-quantized stream.

    The serving co-sim (`repro.serving.cosim`) captures the KV-cache
    page-group traffic one `EngineCore` run generates and replays it
    through `DramSim.run_ticks` as the demand stream. The replay must be
    exact: `generate()` returns the stored stream verbatim, with think
    gaps stored in *ticks* and scaled back to ns by `dt_ns` so that
    `quantize_streams` (the shared quantization) reproduces the original
    tick gaps bit-for-bit (``int(k * dt / dt + 0.5) == k``).

    Single-core by construction (``n_cores == 1``): `run_ticks` serves
    each bank queue FIFO and a single core issues in stream order, so
    the k-th access the trace emits on bank b is exactly the k-th serve
    on bank b — the property the co-sim's per-request stall attribution
    relies on, even when the write buffer back-pressures the core.
    """
    #: dict(is_write [N] bool, bank [N], row [N], subarray [N],
    #: think_ticks [N] int) — think_ticks[i] is the gap BEFORE request i
    stream: dict = None
    dt_ns: float = 6.0

    def generate(self, n_banks: int, n_subarrays: int, n_rows: int = 4096):
        s = self.stream
        assert s is not None and self.n_cores == 1
        bank = np.asarray(s["bank"], np.int64)
        row = np.asarray(s["row"], np.int64)
        sub = np.asarray(s["subarray"], np.int64)
        ticks = np.asarray(s["think_ticks"], np.int64)
        assert bank.size == 0 or (bank.min() >= 0 and bank.max() < n_banks)
        assert row.size == 0 or (row.min() >= 0 and row.max() < n_rows)
        assert sub.size == 0 or (sub.min() >= 0 and sub.max() < n_subarrays)
        assert ticks.size == 0 or ticks.min() >= 0
        return [dict(is_write=np.asarray(s["is_write"], bool),
                     bank=bank, row=row, subarray=sub,
                     think=ticks.astype(np.float64) * self.dt_ns)]


def trace_workload(name: str, stream: dict, *, dt_ns: float = 6.0,
                   seed: int = 0) -> TraceWorkload:
    """Wrap a captured request stream as a replayable `TraceWorkload`."""
    n = len(stream["bank"])
    return TraceWorkload(name=name, n_cores=1, mlp=1 << 20, think_ns=0.0,
                         row_hit_rate=0.0, write_ratio=0.0,
                         reqs_per_core=n, seed=seed, stream=stream,
                         dt_ns=dt_ns)


def quantize_streams(streams, dt_ns: float = 6.0):
    """Quantize `Workload.generate` streams to the sweep engine's integer
    tick quantum: think gaps become ``int(think / dt_ns + 0.5)`` ticks
    (>= 0). This is THE shared quantization — `DramSim.run_ticks` and the
    sweep engine's closed-loop mode both consume it, so a (workload, seed)
    pair yields bit-identical demand on either path.
    """
    out = []
    for s in streams:
        think = np.maximum(
            0, np.floor(np.asarray(s["think"]) / dt_ns + 0.5)
        ).astype(np.int32)
        out.append(dict(is_write=np.asarray(s["is_write"], bool),
                        bank=np.asarray(s["bank"], np.int32),
                        row=np.asarray(s["row"], np.int32),
                        subarray=np.asarray(s["subarray"], np.int32),
                        think=think))
    return out


def make_workload(name: str = "mixed", n_cores: int = 8, reqs_per_core: int = 3000,
                  seed: int = 0) -> Workload:
    presets = {
        # memory-intensive, medium locality (the paper's high-MPKI mixes)
        "mixed": dict(mlp=3, think_ns=15.0, row_hit_rate=0.50, write_ratio=0.30),
        "read_heavy": dict(mlp=2, think_ns=10.0, row_hit_rate=0.60, write_ratio=0.10),
        "write_heavy": dict(mlp=4, think_ns=15.0, row_hit_rate=0.50, write_ratio=0.45),
        # latency-critical: core stalls on every miss (highest refresh impact)
        "low_mlp": dict(mlp=1, think_ns=5.0, row_hit_rate=0.40, write_ratio=0.20),
        # bandwidth-bound streaming
        "streaming": dict(mlp=8, think_ns=5.0, row_hit_rate=0.85, write_ratio=0.33),
    }
    return Workload(name=name, n_cores=n_cores, reqs_per_core=reqs_per_core,
                    seed=seed, **presets[name])
