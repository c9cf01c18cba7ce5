"""Seconds a set in the program's span "texture write" (mvs/pipeline.py: the
textured mesh written as PLY, mvs/texture.py), from its non-synchronising
stage spans."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "texture write")
