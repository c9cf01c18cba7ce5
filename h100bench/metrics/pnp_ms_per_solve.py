"""Milliseconds of PnP a solve: the program's span "pnp" (sfm/incremental.py,
each view's ops/pnp.py::solve_pnp_ransac through its host read) over its
counter "pnp solves" (one a call). None where either is missing: a program
without the counter, or a window without a solve."""

from h100bench.metrics._program import counter


def read(ctx: dict) -> float | None:
    spent, n = ctx["stages"].get("pnp"), counter("pnp solves")
    return None if spent is None or not n else 1e3 * spent / n
