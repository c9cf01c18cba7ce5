"""The port's span-and-counter recorder: optional wall timers around the
CLI's stages (features, sfm, dense) and their parts, and counters of host
integers.

`stage(name)` is a bare no-op unless `enable()` was called. When enabled,
it records the block as a span (name, start ns, end ns, shard) on
time.time_ns(), the clock torch.profiler stamps its CPU and CUDA events
with, and adds its wall to the name's total. It never synchronises a card:
a span is the host's wall in the block, and device work the block
launched but did not wait for falls to whatever the host does next (every
stage of the CLI ends in a host read). So spans nest inside launch-bound
loops without slowing them, and a trace of the card's activity shows where
the host was while the card sat idle. Spans may nest; each name keeps its
own total, so an inner span leaves the outer one's total as it was.

`count(name, n)` adds the host integer n to a counter; off, it does
nothing. It never reads a device value: the caller passes what the host
already knows (a loop's iteration count).

Stages of the same name add up. A shard thread
(parallel/distributed.py::Shards.run) keeps its own totals, and merge()
adds each stage's longest shard total once the threads end (and all their
calls), so each total stays a wall and the parts of a mesh run, or of a
rank's, still add up to at most its wall. A shard thread's spans carry its
shard, and its counters add to the process's. Where a process holds
several shards a collective's total is the longest time a shard spent in
it, waiting for the other shards (and, under torchrun, the other ranks)
included.

`report()` returns the totals and call counts, `counters()` the counters,
`spans()` the spans, all since the last enable(); enable(False) stops the
recording and keeps them for reading.
"""

from __future__ import annotations

import contextlib
import numbers
import threading
import time

_enabled = False
_totals: dict[str, float] = {}
_counts: dict[str, int] = {}
_counters: dict[str, int] = {}
_spans: list[tuple[str, int, int, int | None]] = []
_lock = threading.Lock()
_local = threading.local()


def enable(on: bool = True) -> None:
    """Turn the recorder on (and clear it) or off (keeping what it holds)."""
    global _enabled
    if on:
        with _lock:
            _totals.clear()
            _counts.clear()
            _counters.clear()
            _spans.clear()
    _enabled = on


@contextlib.contextmanager
def shard_thread(into: list, shard: int):
    """Mark the calling thread as shard `shard`'s of a process: its stages
    are kept apart and appended to `into` as (totals, counts) when it ends;
    its spans carry `shard`."""
    _local.shard, _local.index = ({}, {}), shard
    try:
        yield
    finally:
        into.append(_local.shard)
        _local.shard = _local.index = None


def merge(parts: list) -> None:
    """Add the shard threads' stages (shard_thread's `into`): each stage's
    longest shard total and the calls of every shard."""
    with _lock:
        for name in {k for totals, _ in parts for k in totals}:
            _totals[name] = _totals.get(name, 0.0) + max(t.get(name, 0.0) for t, _ in parts)
            _counts[name] = _counts.get(name, 0) + sum(c.get(name, 0) for _, c in parts)


@contextlib.contextmanager
def stage(name: str):
    if not _enabled:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        t1 = time.time_ns()
        mine = getattr(_local, "shard", None)
        totals, counts = mine if mine is not None else (_totals, _counts)
        with _lock:
            totals[name] = totals.get(name, 0.0) + (t1 - t0) / 1e9
            counts[name] = counts.get(name, 0) + 1
            _spans.append((name, t0, t1, getattr(_local, "index", None)))


def count(name: str, n: int = 1) -> None:
    """Add the host integer n to counter `name` (a no-op while off)."""
    if not _enabled:
        return
    if not isinstance(n, numbers.Integral):
        raise TypeError(f"count({name!r}) takes a host integer, not {type(n).__name__}")
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def report() -> dict[str, tuple[float, int]]:
    """{stage: (seconds, calls)} since the last enable()."""
    with _lock:
        return {k: (_totals[k], _counts[k]) for k in _totals}


def counters() -> dict[str, int]:
    """{counter: total} since the last enable()."""
    with _lock:
        return dict(_counters)


def spans() -> list[tuple[str, int, int, int | None]]:
    """[(name, start ns, end ns, shard or None on a process's own thread)]
    since the last enable(), in the order they ended."""
    with _lock:
        return list(_spans)
