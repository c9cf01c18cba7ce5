"""Seconds a set in the program's span "mesh backproject" (mvs/mesh.py: each
view's depth map back-projected and triangulated), from its
non-synchronising stage spans."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "mesh backproject")
