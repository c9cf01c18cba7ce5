"""Seconds a set in the program's stage "sgm" (mvs/sgm.py and K2b), from its
synchronising stage timer."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "sgm")
