"""Optional wall timers around the CLI's stages (features, sfm, dense) and
the dense stage's parts.

`stage(name)` is a no-op unless `enable()` was called. When enabled, it
synchronises before and after the block, so each total is the wall of
that part including its device work; the synchronisation itself slows a
run, so only a measurement turns it on (chip_smoke.py's dense and ORB
phases). On the main thread it synchronises every card the shards of this
process have run on (watch: a mesh's, or a rank's block) besides the
current one; in a shard thread (parallel/distributed.py::Shards.run)
only that thread's stream, so a shard's timer waits for its own work and
not for the other cards'. Stages of the same name add up. A shard thread
keeps its own totals, and merge() adds each stage's longest shard total
once the threads end (and all their calls), so each total stays a wall
and the parts of a mesh run, or of a rank's, still add up to at most its
wall. Where a process holds several shards a collective's total is the
longest time a shard spent in it, waiting for the other shards (and, under
torchrun, the other ranks) included.
`report()` returns the totals and call counts.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_enabled = False
_totals: dict[str, float] = {}
_counts: dict[str, int] = {}
_lock = threading.Lock()
_watched: set[int] = set()  # card indices the shards of this process run on
_local = threading.local()


def enable(on: bool = True) -> None:
    """Turn the timers on (and clear them) or off."""
    global _enabled
    _enabled = on
    with _lock:
        _totals.clear()
        _counts.clear()


def watch(devices) -> None:
    """Have the main thread's timers synchronise these devices' cards too."""
    with _lock:
        _watched.update(torch.device(d).index for d in devices
                        if torch.device(d).type == "cuda" and torch.device(d).index is not None)


@contextlib.contextmanager
def shard_thread(into: list):
    """Mark the calling thread as one shard's of a process: its stages are kept
    apart and appended to `into` as (totals, counts) when it ends."""
    _local.shard = ({}, {})
    try:
        yield
    finally:
        into.append(_local.shard)
        _local.shard = None


def merge(parts: list) -> None:
    """Add the shard threads' stages (shard_thread's `into`): each stage's
    longest shard total and the calls of every shard."""
    with _lock:
        for name in {k for totals, _ in parts for k in totals}:
            _totals[name] = _totals.get(name, 0.0) + max(t.get(name, 0.0) for t, _ in parts)
            _counts[name] = _counts.get(name, 0) + sum(c.get(name, 0) for _, c in parts)


def _sync() -> None:
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return
    if getattr(_local, "shard", None) is not None:
        torch.cuda.current_stream().synchronize()
        return
    torch.cuda.synchronize()
    for i in sorted(_watched):
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def stage(name: str):
    if not _enabled:
        yield
        return
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        dt = time.perf_counter() - t0
        mine = getattr(_local, "shard", None)
        totals, counts = mine if mine is not None else (_totals, _counts)
        with _lock:
            totals[name] = totals.get(name, 0.0) + dt
            counts[name] = counts.get(name, 0) + 1


def report() -> dict[str, tuple[float, int]]:
    """{stage: (seconds, calls)} since the last enable()."""
    with _lock:
        return {k: (_totals[k], _counts[k]) for k in _totals}
