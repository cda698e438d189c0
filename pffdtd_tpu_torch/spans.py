"""Spans: named intervals of the program's set-up and runs, kept in memory.

    with span("engine.upload", mem=device):   # a block
        ...

    @span("scene.fold")                         # every call of a function
    def fold_fcc_sim(sim): ...

Each span appends one `Span` to a bounded store when it ends: its name,
the enclosing span's name (`parent`), the number of the `TorchEngine.run`
call it belongs to (`run`, None during set-up), its start and end on
`time.perf_counter_ns`, and the time the spans directly inside it took.
With `mem` a CUDA device it also holds the caching allocator's counters
for that device: `torch.cuda.memory_allocated` at entry and exit and
`torch.cuda.max_memory_allocated` at exit, host-side reads that never
wait for the card; on any other device they are None.

While `torch.profiler` records, a span also opens
`record_function("pffdtd." + name)`, so its range lands in the profiler's
trace beside the kernels, on the profiler's clock.  Otherwise a span costs
a `perf_counter_ns` pair and an append.

No span is opened per step: spans mark set-up stages and the host work of
a run around its step loop.  The store keeps the last `MAX_RECORDS`
spans; `records()` reads it, `reset()` empties it.  One thread opens
spans (the program runs on one)."""

from __future__ import annotations

import functools
import time
from collections import deque
from typing import NamedTuple

import torch

MAX_RECORDS = 4096


class Span(NamedTuple):
    """One ended span; times in ns of `time.perf_counter_ns`, memory in
    bytes (None off a CUDA device)."""
    name: str
    parent: str | None
    run: int | None
    t0_ns: int
    t1_ns: int
    child_ns: int
    mem_in: int | None = None
    mem_out: int | None = None
    mem_peak: int | None = None

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    @property
    def self_seconds(self) -> float:
        """`seconds` less what the spans directly inside it took."""
        return (self.t1_ns - self.t0_ns - self.child_ns) * 1e-9


_records: deque = deque(maxlen=MAX_RECORDS)
_open: list = []      # [name, ns of the spans directly inside] of open spans
_run: int | None = None
_runs = 0


class span:
    """A span named `name` around a `with` block, or around each call of
    the function it decorates; `mem`: the device whose allocator it reads
    (CUDA devices only)."""

    __slots__ = ("name", "dev", "t0", "mem_in", "frame", "rf")

    def __init__(self, name: str, mem=None):
        self.name = name
        dev = None if mem is None else torch.device(mem)
        self.dev = dev if dev is not None and dev.type == "cuda" else None

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("pffdtd." + self.name)
            self.rf.__enter__()
        self.mem_in = None if self.dev is None else \
            torch.cuda.memory_allocated(self.dev)
        self.frame = [self.name, 0]
        _open.append(self.frame)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _open.pop()
        if _open:
            _open[-1][1] += t1 - self.t0
        mem_out = mem_peak = None
        if self.dev is not None:
            st = torch.cuda.memory_stats(self.dev)
            mem_out = st.get("allocated_bytes.all.current", 0)
            mem_peak = st.get("allocated_bytes.all.peak", 0)
        _records.append(Span(self.name, _open[-1][0] if _open else None,
                             _run, self.t0, t1, self.frame[1], self.mem_in,
                             mem_out, mem_peak))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name, dev = self.name, self.dev

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, dev):
                return fn(*args, **kwargs)
        return spanned


def numbered_run(fn):
    """Decorator: each call of `fn` is the next run; the spans opened
    inside carry its number."""
    @functools.wraps(fn)
    def counted(*args, **kwargs):
        global _run, _runs
        _runs += 1
        outer, _run = _run, _runs
        try:
            return fn(*args, **kwargs)
        finally:
            _run = outer
    return counted


def records(since_ns: int | None = None) -> list:
    """The stored spans in the order they ended; with `since_ns`, those
    that started at or after it (a `time.perf_counter_ns()` reading)."""
    if since_ns is None:
        return list(_records)
    return [r for r in _records if r.t0_ns >= since_ns]


def reset():
    """Empty the store and number runs from 1 again."""
    global _runs
    _records.clear()
    _runs = 0
