"""Levenberg-Marquardt iterations a set: the program's counter "lm
iterations" (sfm/ba.py::lm_solve adds each bundle adjustment's iterations,
those of abandoned SfM starts too) over the sets of the window."""

from h100bench.metrics._program import counter


def read(ctx: dict) -> float | None:
    n = counter("lm iterations")
    return None if n is None else n / ctx["sets"]
