"""Seconds a set in the program's span "fusion write" (mvs/pipeline.py: the
dense cloud written as PLY, utils/ply.py), from its non-synchronising stage
spans."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "fusion write")
