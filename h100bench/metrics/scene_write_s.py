"""Seconds a set in the program's span "scene write" (utils/checkpoint.py:
the scene.npz checkpoint and its .json), from its non-synchronising span
recorder."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "scene write")
