"""Share of PnP's Gauss-Newton steps that ran as a CUDA graph replay, in %:
the program's counter "pnp graph steps" (ops/pnp.py::solve_pnp_ransac adds
a solve's steps where it replayed its polish step from one CUDA graph) over
its counter "pnp gn steps". None where either counter is missing: a
program without the graph route, or a window in which no solve took it."""

from h100bench.metrics._program import counter


def read(ctx: dict) -> float | None:
    n, graphed = counter("pnp gn steps"), counter("pnp graph steps")
    return None if not n or graphed is None else 100.0 * graphed / n
