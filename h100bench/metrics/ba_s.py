"""Seconds a set in the program's span "ba" (sfm/incremental.py: every bundle
adjustment, sfm/ba.py), from its non-synchronising stage spans."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "ba")
