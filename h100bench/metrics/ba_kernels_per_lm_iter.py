"""Kernels a Levenberg-Marquardt iteration: the device's kernel events
(torch.profiler, CUDA activity; copies and sets left out) that start inside
the program's "ba" spans, over its counter "lm iterations". A bundle
adjustment ends in a copy to the host, so its kernels start inside its
span. None without a "ba" span, an iteration or a device event."""

import numpy as np

from h100bench.metrics._program import counter, spans, starts_ends

NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx: dict) -> float | None:
    found, n = spans("ba"), counter("lm iterations")
    kernels = [e for e in ctx["events"] if not e[0].startswith(NOT_KERNELS)]
    if not found or not n or not kernels:
        return None
    starts = np.sort(starts_ends(kernels)[0])
    inside = sum(int(np.searchsorted(starts, b, "right") - np.searchsorted(starts, a, "left"))
                 for a, b in found)
    return inside / n
