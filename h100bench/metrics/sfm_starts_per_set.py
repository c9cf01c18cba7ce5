"""SfM starts a set: the program's counter "sfm starts" (one a pass of
sfm/incremental.py::reconstruct's restart loop) over the sets of the
window; 1 where no start was abandoned."""

from h100bench.metrics._program import counter


def read(ctx: dict) -> float | None:
    n = counter("sfm starts")
    return None if n is None else n / ctx["sets"]
