"""The readers of pnp_graph_step_pct and pnp_ms_per_solve on a hand-built
context with the program's recorder stubbed: the share and the ms from the
counters and the "pnp" span, None without them, and the four entries
(each with its `.orb` twin) in the benchmark."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench.manifest import Bench  # noqa: E402
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer  # noqa: E402

SIFT, ORB = "unordered-sift-bf.sparse-1080p", "unordered-orb-bf.sparse-1080p"


def read(metric, stages=None):
    ctx = {"stages": stages or {}, "events": [], "sets": 4}
    return Bench(ROOT).reader(metric)(ctx)


@pytest.mark.parametrize("metric", ["pnp_graph_step_pct", "pnp_graph_step_pct.orb"])
@pytest.mark.parametrize("counters,share", [
    ({"pnp gn steps": 300, "pnp graph steps": 300}, 100.0),
    ({"pnp gn steps": 300, "pnp graph steps": 75}, 25.0),
    ({"pnp gn steps": 300, "pnp graph steps": 0}, 0.0),
    ({"pnp gn steps": 300}, None),  # a program without the graph route
    ({"pnp graph steps": 0}, None),
    ({"pnp gn steps": 0, "pnp graph steps": 0}, None),
    ({}, None),
])
def test_pnp_graph_step_pct(monkeypatch, metric, counters, share):
    monkeypatch.setattr(stage_timer, "counters", lambda: dict(counters))
    assert read(metric) == share


@pytest.mark.parametrize("metric", ["pnp_ms_per_solve", "pnp_ms_per_solve.orb"])
@pytest.mark.parametrize("stages,counters,ms", [
    ({"pnp": 2.5}, {"pnp solves": 50}, 50.0),
    ({"pnp": 0.3, "ba": 7.0}, {"pnp solves": 4, "lm iterations": 9}, 75.0),
    ({"pnp": 2.5}, {}, None),  # a program without the counter
    ({"pnp": 2.5}, {"pnp solves": 0}, None),
    ({}, {"pnp solves": 50}, None),
])
def test_pnp_ms_per_solve(monkeypatch, metric, stages, counters, ms):
    monkeypatch.setattr(stage_timer, "counters", lambda: dict(counters))
    assert read(metric, stages) == (None if ms is None else pytest.approx(ms))


@pytest.mark.parametrize("metric", ["pnp_graph_step_pct", "pnp_ms_per_solve"])
def test_pnp_readers_without_counters(monkeypatch, metric):
    """A recorder without counters(), as before they existed."""
    monkeypatch.delattr(stage_timer, "counters")
    assert read(metric, {"pnp": 2.5}) is None


@pytest.mark.parametrize("name,unit,better,source,cell", [
    ("pnp_graph_step_pct", "%", "higher", "program_counter", SIFT),
    ("pnp_ms_per_solve", "ms", "lower", "program_span", SIFT),
    ("pnp_graph_step_pct.orb", "%", "higher", "program_counter", ORB),
    ("pnp_ms_per_solve.orb", "ms", "lower", "program_span", ORB),
])
def test_pnp_metrics_are_in_the_benchmark(name, unit, better, source, cell):
    bench = Bench(ROOT)
    entry, = [m for m in bench.spec["per_layer"] if m["name"] == name]
    assert entry == {"name": name, "unit": unit, "better": better, "source": source,
                     "layer": "ops/pnp.py", "moves": "sparse_s_per_set", "workloads": [cell]}
    assert name in {m["name"] for m in bench.metrics(cell, trace=True)}
    assert bench.reader_path(name).endswith(f"metrics/{name.split('.')[0]}.py")
