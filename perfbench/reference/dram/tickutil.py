"""Frozen copy of the three helpers `DramSim.run_ticks` takes from the
sweep engine (`repro_torch/core/sweep/engine.py`): the read-latency
histogram width, its p99 scan and the one-bank refreshing-subarray test."""
from __future__ import annotations

import math

import numpy as np

#: read-latency histogram width (ticks); larger waits clip into the top bin
MAX_LAT_TICKS = 4095


def _scalar_refreshing_sub(ru_subs, t: int) -> int:
    mid = [i for i, ru in enumerate(ru_subs) if ru > t]
    return mid[0] if len(mid) == 1 else -1


def _p99_ticks(hist_row: np.ndarray, n_reads: int) -> int:
    if n_reads <= 0:
        return 0
    target = math.ceil(0.99 * n_reads)
    return int(np.searchsorted(np.cumsum(hist_row), target, side="left"))
