"""The reader of ba_graph_iter_pct on a hand-built context with the
program's recorder stubbed: the share from the two counters, None without
them, and its entry in the benchmark."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench.manifest import Bench  # noqa: E402
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer  # noqa: E402


def read():
    return Bench(ROOT).reader("ba_graph_iter_pct")({"stages": {}, "events": [], "sets": 4})


@pytest.mark.parametrize("counters,share", [
    ({"lm iterations": 400, "ba graph iterations": 400}, 100.0),
    ({"lm iterations": 400, "ba graph iterations": 100}, 25.0),
    ({"lm iterations": 400, "ba graph iterations": 0}, 0.0),
    ({"lm iterations": 400}, None),  # a program without the graph route
    ({"ba graph iterations": 0}, None),
    ({"lm iterations": 0, "ba graph iterations": 0}, None),
    ({}, None),
])
def test_ba_graph_iter_pct(monkeypatch, counters, share):
    monkeypatch.setattr(stage_timer, "counters", lambda: dict(counters))
    assert read() == share


def test_ba_graph_iter_pct_without_counters(monkeypatch):
    """A recorder without counters(), as before they existed."""
    monkeypatch.delattr(stage_timer, "counters")
    assert read() is None


def test_ba_graph_iter_pct_is_in_the_benchmark():
    entry, = [m for m in Bench(ROOT).spec["per_layer"] if m["name"] == "ba_graph_iter_pct"]
    assert entry == {"name": "ba_graph_iter_pct", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "sfm/ba.py",
                     "moves": "sparse_s_per_set",
                     "workloads": ["unordered-sift-bf.sparse-1080p"]}
