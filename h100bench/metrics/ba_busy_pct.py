"""Percent of the bundle adjustments' wall in which the card ran something:
the union of the device events (kernels, copies, sets; torch.profiler,
CUDA activity) clipped to each of the program's "ba" spans, over the spans'
length. Both are on the profiler's clock. None without a "ba" span or a
device event."""

import numpy as np

from h100bench import trace
from h100bench.metrics._program import spans, starts_ends


def read(ctx: dict) -> float | None:
    found, events = spans("ba"), ctx["events"]
    if not found or not events:
        return None
    starts, ends = starts_ends(events)
    busy = 0.0
    for a, b in found:
        near = np.nonzero((starts < b) & (ends > a))[0]
        busy += trace.busy_s([events[i] for i in near], a, b)
    return 100.0 * busy / (sum(b - a for a, b in found) / 1e9)
