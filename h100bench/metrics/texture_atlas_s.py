"""Seconds a set in the program's span "texture atlas" (mvs/pipeline.py:
mvs/texture.py::build_texture_atlas, the view selection, sampling and
assembly through the atlas's host read, inside "texture"), from its
non-synchronising stage spans."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "texture atlas")
