"""Seconds a set in the program's span "match" (sfm/incremental.py: the pairs'
2-NN matching, K1, through the results' copy to the host), from its
non-synchronising stage spans."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "match")
