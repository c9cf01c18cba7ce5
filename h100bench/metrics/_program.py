"""What the readers of the program's counters and spans share. Both are
read at read time from the program's recorder
(sfm_mvs_pipeline_tpu_torch/utils/stage_timer.py), which the harness turns
off, keeping what it holds, before the readers run. A program whose
recorder has no counters() or spans() gives None, as does a counter or span
that never ran."""

from __future__ import annotations


def _recorder():
    from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

    return stage_timer


def counter(name: str) -> int | None:
    """The program's counter `name` over the window, or None."""
    counters = getattr(_recorder(), "counters", None)
    return None if counters is None else counters().get(name)


def spans(name: str) -> list[tuple[int, int]] | None:
    """[(start ns, end ns)] of the program's spans `name` in the window (the
    profiler's clock), or None where there is none."""
    read = getattr(_recorder(), "spans", None)
    found = [] if read is None else [(s[1], s[2]) for s in read() if s[0] == name]
    return found or None


def starts_ends(events) -> tuple:
    """The device events' start and end ns as two int64 arrays."""
    import numpy as np

    starts = np.fromiter((e[1] for e in events), np.int64, len(events))
    ends = np.fromiter((e[2] for e in events), np.int64, len(events))
    return starts, ends
