"""Seconds a set in the program's stage "patchmatch" (mvs/patchmatch.py:
each rectified pair's PatchMatch, or a view's warp-based PatchMatch). The
spans do not synchronise, so this is the host's launch time; K3's device
time that the host did not wait for falls to the span that next reads the
card ("consensus")."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "patchmatch")
