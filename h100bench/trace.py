"""What a `--trace 1` run reads: the program's stage spans and the card's
activity over the window.

Stage spans: the program's synchronising stage timers
(sfm_mvs_pipeline_tpu_torch/utils/stage_timer.py), turned on for the
window; `record_spans` also keeps each span's host-clock interval, so the
card's idle gaps can be named by the stage the host was in.

Device activity: a torch.profiler capture with CUDA activity alone (the
card's kernels, copies and sets), held in memory and never exported.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


def record_spans(stage_timer) -> list:
    """Wrap stage_timer.stage so every span also lands in the returned list
    as (name, start ns, end ns) on the host's wall clock. Call it before the
    program's modules import `stage`."""
    spans: list = []
    inner = stage_timer.stage

    @contextlib.contextmanager
    def stage(name: str):
        t0 = time.time_ns()
        with inner(name):
            yield
        spans.append((name, t0, time.time_ns()))

    stage_timer.stage = stage
    return spans


@contextlib.contextmanager
def device_capture(out: dict):
    """Profile the block's CUDA activity; on exit `out["events"]` holds
    (name, start ns, end ns) of every device event, on the host's clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
    events = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
            events.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    out["events"] = sorted(events, key=lambda x: x[1])


def merged(events, lo: int, hi: int) -> list[list[int]]:
    """The union of the events' intervals, clipped to [lo, hi], sorted."""
    out: list[list[int]] = []
    for _, a, b in sorted(events, key=lambda x: x[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(events, lo: int, hi: int) -> float:
    """Seconds of [lo, hi] in which some device event ran."""
    return sum(b - a for a, b in merged(events, lo, hi)) / 1e9


def by_name(events) -> list[list]:
    """[[kernel name, device seconds], ...], the longest total first."""
    tot: dict[str, float] = {}
    for name, a, b in events:
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in tot.items()), key=lambda x: -x[1])


def idle_gaps(events, spans, lo: int, hi: int, top: int = 10) -> list[list]:
    """The card's idle time in [lo, hi] by what the host was doing: each
    stretch with no device event is put to the innermost stage span around
    its middle ("no stage" where the host was outside every span), and the
    `top` stages with the most idle seconds are returned, the most first."""
    busy = merged(events, lo, hi)
    edges = np.array([lo] + [t for iv in busy for t in iv] + [hi], np.int64).reshape(-1, 2)
    edges = edges[edges[:, 1] > edges[:, 0]]
    mids = (edges[:, 0] + edges[:, 1]) // 2
    owner = np.full(len(edges), -1)
    order = sorted(range(len(spans)), key=lambda j: spans[j][1] - spans[j][2])  # longest first
    for j in order:  # a shorter span inside a longer one takes the gap over
        owner[(mids >= spans[j][1]) & (mids <= spans[j][2])] = j
    idle: dict[str, float] = {}
    for j, secs in zip(owner, (edges[:, 1] - edges[:, 0]) / 1e9):
        name = spans[j][0] if j >= 0 else "no stage"
        idle[name] = idle.get(name, 0.0) + float(secs)
    return sorted(([k, v] for k, v in idle.items()), key=lambda x: -x[1])[:top]
