"""Seconds a set in the program's span "pair pose" (sfm/incremental.py: E-vs-H
pose and triangulation of baseline candidates and adjoining pairs), from its
non-synchronising stage spans."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "pair pose")
