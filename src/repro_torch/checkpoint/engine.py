"""Asynchronous checkpointing with DARP-scheduled flush windows, mirroring
`repro/checkpoint/engine.py`.

Epoch model (consistency): every `interval` steps a checkpoint *epoch*
snapshots the full train state to host memory (each leaf copied off the
card; a DTensor leaf as its `full_tensor()`, so a sharded state writes
the bytes of the unsharded one). The disk flushes of the N banks of
leaves are then *scheduled* across the following steps' write windows by the DARP scheduler
(`core/scheduler/darp.py`): out of order, budget-bounded (a bank's flush
may be postponed at most `budget` sub-windows; preemption pulls
everything in at once, the paper's pull-in path). A checkpoint becomes
restorable when its manifest lists all banks flushed and checksummed
(written last, by atomic rename).

On disk it is the reference's format: `step_{step:08d}/bank_{b}.npz`
keyed by leaf index in JAX's flatten order (`common/treeutil.py`),
`bank_{b}.crc.json` (crc32 of each leaf's bytes) and `manifest.json`
with the leaves' `flat_paths`. A bfloat16 leaf is written as the raw
two-byte `|V2` array the reference's `np.savez` writes for
`ml_dtypes.bfloat16`, so checkpoints cross between the packages.

Departures from the reference, all deliberate:
  * `restore` views a `|V2` leaf back as bfloat16. The reference casts
    it with `astype` (`repro/checkpoint/engine.py:243`), which numpy
    refuses for `|V2`, so the reference cannot restore bf16 leaves
    (`OptConfig(moment_dtype="bfloat16")`); the port can.
  * `flush_all_now` with no epoch snapshotted yet flushes nothing. The
    reference's flushes a bank of `None` and raises `TypeError`
    (`repro/checkpoint/engine.py:132,154`): a trainer resumed from a
    checkpoint that ends before its next epoch boundary crashes in its
    final flush.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.common.treeutil import flat_paths, flatten_up_to, \
    tree_flatten, tree_unflatten
from repro_torch.core.policy import RefreshPolicy
from repro_torch.core.scheduler import DarpScheduler, SchedulerPolicy
from repro_torch.parallel.sharding import full


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    interval: int = 50           # steps per checkpoint epoch
    n_banks: int = 8             # banks of leaves flushed independently
    budget: int = 8              # postpone/pull-in budget (paper)
    policy: Union[str, SchedulerPolicy, RefreshPolicy] = "darp"
    keep: int = 2


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def to_host(t: torch.Tensor) -> np.ndarray:
    """A leaf as the numpy array the reference's `jax.device_get` gives:
    bfloat16 as raw two-byte `|V2` (bit for bit), every other dtype as
    itself. A DTensor leaf is gathered whole first (a collective: every
    rank of its mesh calls it)."""
    t = full(t.detach()).to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_host(arr: np.ndarray, template: torch.Tensor) -> torch.Tensor:
    """A stored leaf as a tensor of `template`'s dtype on its device; a
    `|V2` leaf is viewed back as bfloat16."""
    a = np.asarray(arr)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=template.device, dtype=template.dtype)


class CheckpointEngine:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        # one maintenance window per bank per epoch -> interval/n_banks steps
        self.sched = DarpScheduler(
            cfg.n_banks, max(1.0, cfg.interval / cfg.n_banks),
            budget=cfg.budget, policy=cfg.policy)
        self.pool = ThreadPoolExecutor(max_workers=2)
        self._staged: Optional[dict] = None   # epoch snapshot (numpy leaves)
        self._staged_step: Optional[int] = None
        self._flushed_banks: set = set()
        self._pending: list = []
        self._lock = threading.Lock()
        # serializes manifest writes + gc: two pool threads can finish the
        # last two banks of an epoch simultaneously, and gc may retire an
        # epoch while a late flush of it is still completing
        self._manifest_lock = threading.Lock()
        self.stats = {"epochs": 0, "flushes": 0, "forced": 0, "snap_ms": 0.0,
                      "flush_ms": 0.0}

    # ------------------------------------------------------------ banks
    def _bank_split(self, leaves: list) -> list[list[int]]:
        banks = [[] for _ in range(self.cfg.n_banks)]
        for i in range(len(leaves)):
            banks[i % self.cfg.n_banks].append(i)
        return banks

    # ------------------------------------------------------------ public
    def maybe_snapshot(self, step: int, state: dict) -> bool:
        """Call every step BEFORE the write window; snapshots on epoch
        boundaries. Returns True if a snapshot was taken."""
        if step % self.cfg.interval != 0:
            return False
        return self.force_snapshot(step, state)

    def force_snapshot(self, step: int, state: dict) -> bool:
        t0 = time.perf_counter()
        leaves, treedef = tree_flatten(state)
        host = [to_host(x) for x in leaves]
        with self._lock:
            # a lagging previous epoch is force-flushed first (budget push)
            if self._staged is not None and self._flushed_banks != set(
                    range(self.cfg.n_banks)):
                self._flush_remaining(forced=True)
            self._staged = {"leaves": host, "treedef": treedef,
                            "paths": flat_paths(state)}
            self._staged_step = step
            self._flushed_banks = set()
        self.stats["epochs"] += 1
        self.stats["snap_ms"] += (time.perf_counter() - t0) * 1e3
        return True

    def write_window(self, step: int, busy_banks: Optional[set] = None,
                     max_issues: int = 1) -> list[int]:
        """Call inside every step's write phase: DARP decides which banks
        flush now. busy_banks: banks with pending demand (skipped unless
        forced)."""
        with self._lock:
            if self._staged is None:
                return []
            remaining = set(range(self.cfg.n_banks)) - self._flushed_banks
            if not remaining:
                return []
            demand = [0] * self.cfg.n_banks
            for b in range(self.cfg.n_banks):
                if busy_banks and b in busy_banks:
                    demand[b] = 1
                if b in self._flushed_banks:
                    demand[b] = 99  # nothing to do; make unattractive
            picks = self.sched.select(float(step), demand=demand,
                                      write_window=True, max_issues=max_issues)
            picks = [b for b in picks if b in remaining]
            for b in picks:
                self._flush_bank_async(b)
        return picks

    def flush_all_now(self) -> None:
        """Preemption path: pull in every pending flush immediately."""
        with self._lock:
            self._flush_remaining(forced=True)
        self.pool.shutdown(wait=True)
        self.pool = ThreadPoolExecutor(max_workers=2)

    # ---------------------------------------------------------- internals
    # NOTE: _flushed_banks mutations happen on the caller thread (under
    # self._lock); pool threads only receive immutable (staged, step, bank).

    def _flush_remaining(self, forced: bool = False) -> None:
        if self._staged is None:
            return  # no epoch snapshotted since this engine was made
        for b in sorted(set(range(self.cfg.n_banks)) - self._flushed_banks):
            self._flushed_banks.add(b)
            self._flush_bank(self._staged, self._staged_step, b, forced=forced)

    def _flush_bank_async(self, b: int) -> None:
        self._flushed_banks.add(b)
        self._pending.append(
            self.pool.submit(self._flush_bank, self._staged,
                             self._staged_step, b))

    def _flush_bank(self, staged: dict, step: int, b: int,
                    forced: bool = False) -> None:
        t0 = time.perf_counter()
        leaves = staged["leaves"]
        banks = self._bank_split(leaves)
        ep_dir = os.path.join(self.cfg.directory, f"step_{step:08d}")
        os.makedirs(ep_dir, exist_ok=True)
        arrs = {str(i): leaves[i] for i in banks[b]}
        path = os.path.join(ep_dir, f"bank_{b}.npz")
        tmp = path + f".tmp{b}"
        try:
            with open(tmp, "wb") as fh:  # file handle: savez won't rename it
                np.savez(fh, **arrs)
            os.replace(tmp, path)
            meta = {str(i): _crc(leaves[i]) for i in banks[b]}
            with open(os.path.join(ep_dir, f"bank_{b}.crc.json"), "w") as f:
                json.dump(meta, f)
        except FileNotFoundError:
            return  # epoch dir gc'd concurrently: already superseded
        self.stats["flushes"] += 1
        if forced:
            self.stats["forced"] += 1
        self.stats["flush_ms"] += (time.perf_counter() - t0) * 1e3
        done = all(os.path.exists(os.path.join(ep_dir, f"bank_{x}.npz"))
                   for x in range(self.cfg.n_banks))
        if done:
            self._write_manifest(ep_dir, step, staged)

    def _write_manifest(self, ep_dir: str, step: int, staged: dict) -> None:
        manifest = {
            "step": step,
            "n_banks": self.cfg.n_banks,
            "n_leaves": len(staged["leaves"]),
            "paths": staged["paths"],
            "complete": True,
        }
        with self._manifest_lock:
            if os.path.exists(os.path.join(ep_dir, "manifest.json")):
                return
            tmp = os.path.join(ep_dir, "manifest.json.tmp")
            try:
                with open(tmp, "w") as f:
                    json.dump(manifest, f)
                os.replace(tmp, os.path.join(ep_dir, "manifest.json"))
            except FileNotFoundError:
                return  # epoch dir gc'd concurrently: already superseded
            self._gc()

    def _gc(self) -> None:
        eps = sorted(d for d in os.listdir(self.cfg.directory)
                     if d.startswith("step_"))
        complete = [d for d in eps if os.path.exists(
            os.path.join(self.cfg.directory, d, "manifest.json"))]
        for d in complete[:-self.cfg.keep]:
            shutil.rmtree(os.path.join(self.cfg.directory, d),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def wait(self) -> None:
        for f in self._pending:
            f.result()
        self._pending = []

    def restore(self, template: dict, shardings=None) -> Optional[tuple]:
        """Restore the newest complete epoch into `template`'s structure.
        Returns (state, step) or None. Verifies checksums; each leaf takes
        the dtype and device of the template's leaf, and is re-sharded
        onto `shardings` (a tree like the template's of
        `parallel.NamedSharding` or None, as `launch.specs.to_shardings`
        builds it): a leaf with a sharding becomes a DTensor of its
        placements, distributed from the stored array."""
        step = latest_step(self.cfg.directory)
        if step is None:
            return None
        ep_dir = os.path.join(self.cfg.directory, f"step_{step:08d}")
        with open(os.path.join(ep_dir, "manifest.json")) as f:
            manifest = json.load(f)
        n = manifest["n_leaves"]
        leaves: list = [None] * n
        for b in range(manifest["n_banks"]):
            with np.load(os.path.join(ep_dir, f"bank_{b}.npz")) as z:
                with open(os.path.join(ep_dir, f"bank_{b}.crc.json")) as f:
                    crcs = json.load(f)
                for key in z.files:
                    arr = z[key]
                    if _crc(arr) != crcs[key]:
                        raise IOError(f"checksum mismatch leaf {key} bank {b}")
                    leaves[int(key)] = arr
        assert all(x is not None for x in leaves), "missing leaves"
        t_leaves, treedef = tree_flatten(template)
        assert len(t_leaves) == n, "template/checkpoint structure mismatch"
        shard_leaves = (flatten_up_to(treedef, shardings)
                        if shardings is not None else [None] * n)
        out = [_placed(from_host(arr, tmpl), shd_)
               for arr, tmpl, shd_ in zip(leaves, t_leaves, shard_leaves)]
        return tree_unflatten(treedef, out), step


def _placed(t: torch.Tensor, sharding) -> torch.Tensor:
    """`t` distributed onto `sharding` (None: as it is)."""
    if sharding is None:
        return t
    return distribute_tensor(t, sharding.mesh, list(sharding.placements))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    best = None
    for d in os.listdir(directory):
        if d.startswith("step_") and os.path.exists(
                os.path.join(directory, d, "manifest.json")):
            best = max(best or -1, int(d.split("_")[1]))
    return best
