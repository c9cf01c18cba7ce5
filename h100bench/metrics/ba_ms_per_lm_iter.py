"""Milliseconds of bundle adjustment a Levenberg-Marquardt iteration: the
program's span "ba" (sfm/incremental.py, all of each bundle adjustment:
set-up, the LM loop, the results' copy to the host) over its counter "lm
iterations"."""

from h100bench.metrics._program import counter


def read(ctx: dict) -> float | None:
    spent, n = ctx["stages"].get("ba"), counter("lm iterations")
    return None if spent is None or not n else 1e3 * spent / n
