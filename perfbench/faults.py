"""Faults planted under a training run, for the check that `correct`
comes out false (`control.py --fault`, `test_perfbench_runs.py`).

`edit(kind)` returns ``apply(runner, run=None)``, which wraps the runner's
`make_step` so that the timed path is broken underneath:

- ``unchanged``: the step returns the state it was given;
- ``half``: half of each step's batch is left out and the mean is taken
  over the rest (the step runs over the first half of the rows, with
  `accum` halved where it splits them, else the micro-batch).
"""
from __future__ import annotations


def edit(kind: str):
    if kind not in ("unchanged", "half"):
        raise ValueError(f"unknown fault {kind!r}")

    def apply(runner, _run=None):
        make = runner.make_step

        def make_step(r_, arch, accum):
            step, cfg = make(r_, arch, accum)
            if kind == "unchanged":
                def broken(state, batch):
                    _, met = step(state, batch)
                    return state, met
                return broken, cfg
            half_step, _ = make(r_, arch, max(1, accum // 2))

            def broken(state, batch):
                rows = next(iter(batch.values())).shape[0] // 2
                return half_step(state, {k: v[:rows]
                                         for k, v in batch.items()})
            return broken, cfg

        runner.make_step = make_step
    return apply
