"""Good: every plane constructor states its dtype (DT201/DT202)."""
import numpy as np


class BankState:
    def __init__(self, n_banks):
        self.free = np.zeros(n_banks, dtype=np.float64)
        self.open_row = np.full(n_banks, -1, dtype=np.int64)


def run_ticks(n_banks, horizon):
    phase = np.arange(n_banks, dtype=np.int64)
    done = np.zeros(n_banks, dtype=np.int64)
    for t in range(horizon):
        done[:] = done + (phase <= t)
    return done
