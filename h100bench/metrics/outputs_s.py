"""Seconds a set in the program's stage "outputs" (cli/photogrammetrie.py), from its
synchronising stage timer."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "outputs")
