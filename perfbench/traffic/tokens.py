"""Token batches of a training cell: for the run's seed and a step's
index, ``rows`` sequences of ``seq_len`` ids uniform over ``vocab``,
drawn on the card with a `torch.Generator` (one call a step), each row
its own; ``labels`` are the ids shifted by one (next-token prediction).

Traffic keys: ``seq_len``, ``micro_batch``, ``accum`` (rows a step =
``micro_batch * accum``), ``vocab``.
"""
from __future__ import annotations

import numpy as np
import torch


def rows(traffic: dict) -> int:
    return int(traffic["micro_batch"]) * int(traffic["accum"])


def batch(traffic: dict, seed: int, step: int, device) -> dict:
    s = np.random.SeedSequence([int(seed) & (2 ** 63 - 1), int(step), 5])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s.generate_state(1, np.uint64)[0] >> 1))
    x = torch.randint(0, int(traffic["vocab"]),
                      (rows(traffic), int(traffic["seq_len"]) + 1),
                      generator=gen, device=device, dtype=torch.int64)
    return {"tokens": x[:, :-1].contiguous(), "labels": x[:, 1:].contiguous()}
