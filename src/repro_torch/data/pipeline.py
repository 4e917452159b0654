"""Deterministic synthetic LM data pipeline with background prefetch, a
copy of `repro/data/pipeline.py` (numpy and threading only).

Streams have learnable structure (noisy affine next-token process) so the
example trainer's loss demonstrably falls. Batches are reproducible per
(seed, step) — restart-safe for checkpoint/resume tests — and sharded by
(host_id, n_hosts) for multi-host data parallelism.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLMData:
    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1, embed_dim: Optional[int] = None,
                 kind: str = "tokens"):
        assert batch % n_hosts == 0
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed, self.host_id, self.n_hosts = seed, host_id, n_hosts
        self.local_batch = batch // n_hosts
        self.embed_dim = embed_dim
        self.kind = kind  # tokens | embeds | encdec

    def batch_at(self, step: int) -> dict:
        rs = np.random.RandomState(
            (self.seed * 1_000_003 + step * 7919 + self.host_id) % (2**31 - 1))
        b, s, v = self.local_batch, self.seq, self.vocab
        # noisy affine token process: learnable transition structure
        a = 31
        t0 = rs.randint(0, v, size=(b, 1))
        noise = rs.randint(0, 17, size=(b, s))
        idx = np.arange(s)[None, :]
        toks = (t0 * pow(a, 1, v) + np.cumsum(noise, 1) * a + idx) % v
        toks = toks.astype(np.int32)
        labels = np.roll(toks, -1, axis=1).astype(np.int32)
        labels[:, -1] = -1
        out = {"tokens": toks, "labels": labels}
        if self.kind in ("embeds", "encdec"):
            e = rs.randn(b, s, self.embed_dim).astype(np.float32) * 0.02
            if self.kind == "embeds":
                out = {"embeds": e, "labels": labels}
            else:
                out = {"enc_embeds": e, "tokens": toks, "labels": labels}
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded) over any batch iterator."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
