"""Closed-loop multi-core workload generator for the DRAM simulator.

Each core is a limited-MLP request engine: up to `mlp` outstanding memory
requests; after a request completes, the core 'computes' for think_ns before
issuing the next. Address streams have tunable row locality and write ratio,
deterministic per seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
        """Per-core request streams: structured arrays of
        (is_write, bank, row, subarray, think_ns)."""
        rs = np.random.RandomState(self.seed)
        streams = []
        for c in range(self.n_cores):
            n = self.reqs_per_core
            is_write = rs.rand(n) < self.write_ratio
            bank = rs.randint(0, n_banks, n)
            row = rs.randint(0, n_rows, n)
            # enforce row locality: with prob row_hit_rate reuse previous
            # (bank, row) of this core
            reuse = rs.rand(n) < self.row_hit_rate
            for i in range(1, n):
                if reuse[i]:
                    bank[i] = bank[i - 1]
                    row[i] = row[i - 1]
            subarray = row % n_subarrays
            think = rs.exponential(self.think_ns, n)
            streams.append(dict(is_write=is_write, bank=bank, row=row,
                                subarray=subarray, think=think))
        return streams


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
