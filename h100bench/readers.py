"""Helpers that the metric readers (metrics/<name>.py) share. A reader
takes the run's context and returns its number, or None where the run gave
it nothing to read; the harness then leaves the metric out."""

from __future__ import annotations


def stage_per_set(ctx: dict, name: str) -> float | None:
    """Seconds of the program's stage `name` a set (synchronising stage
    timers over the window), or None where the stage never ran."""
    total = ctx["stages"].get(name)
    return None if total is None else total / ctx["sets"]

