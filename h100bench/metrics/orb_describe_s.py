"""Seconds a set in the program's span "orb describe" (ops/orb.py: each
level's orientation and steered BRIEF, the bit packing, and the CLI's +-1
expansion), from its non-synchronising span recorder."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "orb describe")
