"""Seconds a set in the program's span "pair ratios" (sfm/incremental.py: the
homography inlier ratios of the pairs, ops/homography.py), from its
non-synchronising stage spans."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "pair ratios")
