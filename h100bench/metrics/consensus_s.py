"""Seconds a set in the program's stage "consensus"
(mvs/rectified.py::consensus_fuse over a view's neighbours' depth maps,
called by the rectified engines). The spans do not synchronise, so this is
the host's launch time, like "patchmatch"."""

from h100bench.readers import stage_per_set


def read(ctx: dict) -> float | None:
    return stage_per_set(ctx, "consensus")
