"""Percent of the window in which the card ran nothing: one less the union
of its kernel, copy and set intervals (torch.profiler, CUDA activity) over
the window's length, or None where the capture holds no device event.
Shared by the `device_idle_pct.<cells>` metrics."""

from h100bench import trace


def read(ctx: dict) -> float | None:
    if not ctx["events"]:
        return None
    busy = trace.busy_s(ctx["events"], ctx["lo"], ctx["hi"])
    return 100.0 * (1.0 - busy / ((ctx["hi"] - ctx["lo"]) / 1e9))
