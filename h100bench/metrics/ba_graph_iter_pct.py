"""Share of Levenberg-Marquardt iterations that ran as a CUDA graph replay,
in %: the program's counter "ba graph iterations" (sfm/ba.py::lm_solve adds
a solve's iterations where it replayed its step from one CUDA graph) over
its counter "lm iterations". None where either counter is missing: a
program without the graph route, or a window in which no solve took it."""

from h100bench.metrics._program import counter


def read(ctx: dict) -> float | None:
    n, graphed = counter("lm iterations"), counter("ba graph iterations")
    return None if not n or graphed is None else 100.0 * graphed / n
