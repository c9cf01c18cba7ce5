"""Seconds a set in the program's stage "sfm" (sfm/incremental.py, sfm/ba.py, ops/ransac.py, ops/pnp.py, ops/matching.py), from its
synchronising stage timer."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "sfm")
