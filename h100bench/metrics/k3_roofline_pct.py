"""K3's share of its roofline: the least time its launches' work needs on
the card (reference/pm_roofline.py::k3_bound_of_counts over the program's
counters "k3 candidate pixels", "k3 window samples", "k3 pixels" and "k3
costs", each summed over the window's launches by
ops/kernels/pm_kernel.py::pm_score_rect), over the device time of the
`pm_score_kernel` events in the window. The bound takes the larger of the
summed bytes' and operations' times; the launches of a set are all bound
by operations but the C = 1 inits, which are bound by bytes, so the share
reads at most ~0.5% of itself low. None without such an event or without
the counters (a program that does not count K3's work)."""

from h100bench.metrics._program import counter
from h100bench.reference.pm_roofline import k3_bound_of_counts

KERNEL = "pm_score_kernel"
COUNTERS = ("k3 candidate pixels", "k3 window samples", "k3 pixels", "k3 costs")


def read(ctx: dict) -> float | None:
    spent = sum(b - a for name, a, b in ctx["events"] if KERNEL in name) / 1e9
    counts = [counter(c) for c in COUNTERS]
    if spent <= 0 or not all(counts):
        return None
    return 100.0 * k3_bound_of_counts(*counts)["bound_s"] / spent
