"""Fault-tolerant trainer: checkpoint/restart, DARP-scheduled async flushes
in the write window, straggler watchdog, preemption (pull-in) handling,
mirroring `repro/train/trainer.py`.

The reference compiles the step with `jax.jit` and donates the state's
buffers (`jit`, `donate`); the port runs the step eagerly and takes
neither. In their place it takes the `device` the state lies on (the
card unless the caller asks for the CPU): batches go there with
`torch.as_tensor`, and a state elsewhere raises.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointEngine
from repro_torch.train.step import check_on_device, require_device


@dataclass
class TrainerConfig:
    total_steps: int = 200
    ckpt: Optional[CheckpointConfig] = None
    log_every: int = 10
    # straggler mitigation: steps slower than straggler_factor x the running
    # median are recorded; after `straggler_patience` consecutive overruns the
    # trainer flags the host for replacement (here: logs + metric).
    straggler_factor: float = 3.0
    straggler_patience: int = 3
    install_signal_handler: bool = False


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable, state: dict,
                 data_iter, *, device="cuda"):
        self.device = require_device(device)
        check_on_device(state, self.device, "the train state")
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.data = data_iter
        self.engine = CheckpointEngine(cfg.ckpt) if cfg.ckpt else None
        self.start_step = 0
        self.history: list[dict] = []
        self.step_times: list[float] = []
        self.straggles = 0
        self._consec_slow = 0
        self._preempted = False
        if cfg.install_signal_handler:
            signal.signal(signal.SIGUSR1, self._on_preempt)

    def _on_preempt(self, *_):
        self._preempted = True

    def preempt(self):
        """Simulated preemption notice (tests call this directly)."""
        self._preempted = True

    # ------------------------------------------------------------------ run
    def maybe_restore(self) -> bool:
        if self.engine is None:
            return False
        res = self.engine.restore(self.state)
        if res is None:
            return False
        self.state, step = res
        self.start_step = step + 1
        return True

    def run(self) -> dict:
        it = iter(self.data)
        step = self.start_step
        while step < self.cfg.total_steps:
            t0 = time.perf_counter()
            batch = next(it)
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
            if self.engine:
                # epoch snapshot BEFORE the step consumes the state
                self.engine.maybe_snapshot(step, self.state)
            self.state, metrics = self.step_fn(self.state, batch)
            # ---- write window: grads are reduced / optimizer ran; flush a
            # DARP-selected checkpoint bank while the next batch loads.
            if self.engine:
                self.engine.write_window(step)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            self._watch_straggler(dt)
            if step % self.cfg.log_every == 0:
                self.history.append({"step": step, "loss": loss, "dt": dt})
            if self._preempted:
                if self.engine:
                    # pull-in path: snapshot NOW and flush every bank
                    self.engine.force_snapshot(step, self.state)
                    self.engine.flush_all_now()
                    self.engine.wait()
                return {"preempted": True, "step": step, "loss": loss}
            step += 1
        if self.engine:
            self.engine.flush_all_now()
            self.engine.wait()
        return {"preempted": False, "step": step - 1,
                "loss": self.history[-1]["loss"] if self.history else None}

    def _watch_straggler(self, dt: float) -> None:
        if len(self.step_times) < 5:
            return
        med = float(np.median(self.step_times[-50:]))
        if dt > self.cfg.straggler_factor * med:
            self.straggles += 1
            self._consec_slow += 1
        else:
            self._consec_slow = 0
