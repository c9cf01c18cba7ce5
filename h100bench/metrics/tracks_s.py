"""Seconds a set in the program's span "tracks" (sfm/incremental.py and
models/scene.py: the host's track bookkeeping), from its non-synchronising
stage spans."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "tracks")
