"""Seconds a set in the program's span "pnp" (sfm/incremental.py: ops/pnp.py's
RANSAC PnP of each view added), from its non-synchronising stage spans."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "pnp")
