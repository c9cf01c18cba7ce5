"""Share of the views densified by PatchMatch that took its rectified
route (K3), in %: the program's counter "pm rect views"
(mvs/pipeline.py::_patchmatch_view adds each view that a neighbour's
rectification geometry admits) over its counter "pm views" (every view
PatchMatch densified; the rest take the warp-based form). None where "pm
views" is missing or 0: a program without the counters, or a window in
which PatchMatch densified no view."""

from h100bench.metrics._program import counter


def read(ctx: dict) -> float | None:
    n = counter("pm views")
    return None if not n else 100.0 * (counter("pm rect views") or 0) / n
