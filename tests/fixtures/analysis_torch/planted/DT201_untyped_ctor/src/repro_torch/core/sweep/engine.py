"""Good: typed constructors (numpy and torch, `**kw` counts as typed),
int32-safe literals, integral plane stores (DT201, DT202, DT204, DT205)."""
import numpy as np
import torch

MAX_LAT_TICKS = 4095


def _run_batched(G, B, horizon):
    bank_free = np.zeros((G, B), dtype=np.int32)
    phase = np.arange(B, dtype=np.int32)
    lat = np.zeros((G, B), dtype=np.int32)
    guard_ok = horizon < 2 ** 31            # comparison guard, not a value
    for t in range(horizon if guard_ok else 0):
        lat[:, :] = (bank_free + phase[None, :]) // 2
        bank_free[:, :] = bank_free + 1
    return bank_free, lat


def _run_torch(G, B, device):
    i32 = dict(dtype=torch.int32, device=device)
    bank_free = torch.zeros((G, B), device=device)
    done = torch.full((G,), -1, dtype=torch.int32, device=device)
    arB = torch.arange(B, dtype=torch.int64, device=device)
    return bank_free, done, arB
