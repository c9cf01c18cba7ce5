"""Seconds a set in the program's span "orb detect" (ops/orb.py: each
pyramid level's FAST test, Harris response, selection and resize, and the
selection over the levels), from its non-synchronising span recorder."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "orb detect")
