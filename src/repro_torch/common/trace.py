"""Spans of the port's own: where a sweep or a training step spends its time.

    from repro_torch.common import trace

    with trace.span("sweep.grid.cells"):
        ...
    with trace.span("train.forward", device):   # also a pair of CUDA events
        ...
    with trace.enable():                        # or any torch.profiler profile
        run()
    for s in trace.records():                   # Span(name, start, end, ...)
        print(s.name, s.end - s.start, trace.device_seconds(s))

A span records ``(name, start, end, parent, root, id)``: its host interval
in `time.perf_counter()` seconds (the clock of the benchmark's window and
of its mapping of the device trace, so the two intersect directly), the
id of the span that encloses it on its thread (None for an outermost
span), and the id of the outermost one, shared by every span of one sweep
or one training step. Given a CUDA device, a span also records a timing
event on the current stream at entry and at exit; `device_seconds` reads
the pair once the caller has synchronised.

Spans record while `enable()` is in force or while a `torch.profiler`
profile records in this process (`recording`). Otherwise `span` returns
one shared no-op context: no clock read, no allocation, no event.
`timed` is the span for a caller that needs the duration itself
(`SweepResult.seconds`): it always reads the clock, and records only
when spans record.

Records accumulate until `clear()`.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: Optional[int]
    root: int
    id: int


_records: list[Span] = []
_events: dict[int, tuple] = {}
_ids = itertools.count()
_local = threading.local()
_enabled = 0
_enabled_lock = threading.Lock()


def recording() -> bool:
    """Whether spans record now: under `enable()`, or while a
    `torch.profiler` profile records (the profiler's own flag, which it
    sets whatever its activities)."""
    return _enabled > 0 or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def enable():
    """Record spans inside the block (blocks may nest)."""
    global _enabled
    with _enabled_lock:
        _enabled += 1
    try:
        yield
    finally:
        with _enabled_lock:
            _enabled -= 1


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Off:
    """The shared context of a span that does not record."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, exc, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "record", "start", "end", "id", "parent",
                 "root", "_ev")

    def __init__(self, name: str, device, record: bool):
        self.name, self.device, self.record = name, device, record
        self._ev = None

    def __enter__(self):
        if self.record:
            st = _stack()
            up = st[-1] if st else None
            self.id = next(_ids)
            self.parent = None if up is None else up.id
            self.root = self.id if up is None else up.root
            st.append(self)
            if (self.device is not None
                    and torch.device(self.device).type == "cuda"):
                self._ev = torch.cuda.Event(enable_timing=True)
                self._ev.record()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._ev is not None:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            _events[self.id] = (self._ev, done)
        self.end = time.perf_counter()
        if self.record:
            _stack().pop()
            _records.append(Span(self.name, self.start, self.end,
                                 self.parent, self.root, self.id))
        return False

    @property
    def seconds(self) -> float:
        """Host seconds from entry to exit."""
        return self.end - self.start


def span(name: str, device=None):
    """A span around a block; with `device` a CUDA device, also timed on
    the device."""
    if not recording():
        return _OFF
    return _Span(name, device, True)


def timed(name: str) -> _Span:
    """A span whose host duration is read whether or not spans record:
    ``with timed(name) as t: ...`` then ``t.seconds``."""
    return _Span(name, None, recording())


def records(window: Optional[tuple] = None) -> list[Span]:
    """The recorded spans in the order they ended; with `window` =
    (t0, t1), those that overlap it, clipped to it."""
    out = list(_records)
    if window is None:
        return out
    t0, t1 = window
    return [s._replace(start=max(s.start, t0), end=min(s.end, t1))
            for s in out if s.end > t0 and s.start < t1]


def device_seconds(s: Span) -> float:
    """Device seconds between the span's CUDA events (call after
    synchronising), or its host seconds where it has none."""
    ev = _events.get(s.id)
    if ev is None:
        return s.end - s.start
    return ev[0].elapsed_time(ev[1]) / 1e3


def clear() -> None:
    """Forget every recorded span and its events."""
    _records.clear()
    _events.clear()
