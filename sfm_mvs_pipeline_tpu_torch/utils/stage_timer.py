"""Optional wall timers around the CLI's stages (features, sfm, dense) and
the dense stage's parts.

`stage(name)` is a no-op unless `enable()` was called. When enabled, it
synchronises the card before and after the block, so each total is the
wall of that part including its device work; the synchronisation itself
slows a run, so only a measurement turns it on (chip_smoke.py's dense
and ORB phases). Stages of the same name add up; `report()` returns the totals and
call counts.
"""

from __future__ import annotations

import contextlib
import time

import torch

_enabled = False
_totals: dict[str, float] = {}
_counts: dict[str, int] = {}


def enable(on: bool = True) -> None:
    """Turn the timers on (and clear them) or off."""
    global _enabled
    _enabled = on
    _totals.clear()
    _counts.clear()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
        _totals[name] = _totals.get(name, 0.0) + time.perf_counter() - t0
        _counts[name] = _counts.get(name, 0) + 1


def report() -> dict[str, tuple[float, int]]:
    """{stage: (seconds, calls)} since the last enable()."""
    return {k: (_totals[k], _counts[k]) for k in _totals}
