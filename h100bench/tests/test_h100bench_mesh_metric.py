"""The reader of mesh_device_vertex_pct (metrics/mesh_device_vertex_pct.py)
on a hand-built context with the program's counters stubbed: its share of
the raw mesh soup's vertices clustered on a card, None where the counters
or the recorder's readers are missing, and its entry in BENCHMARK.json."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench.manifest import Bench  # noqa: E402
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer  # noqa: E402

MS = 1_000_000  # ns


def read(ctx: dict):
    return Bench(ROOT).reader("mesh_device_vertex_pct")(ctx)


def ctx_of() -> dict:
    return {"stages": {}, "events": [], "sets": 4, "lo": 0, "hi": 10_000 * MS}


@pytest.mark.parametrize("counters,share", [
    ({"mesh raw vertices": 20_000_000, "mesh device vertices": 20_000_000}, 100.0),
    ({"mesh raw vertices": 400}, 0.0),  # clustered on the CPU
    ({"mesh raw vertices": 0}, None),
    ({"mesh device vertices": 400}, None),
    ({}, None),  # a program without the counters
])
def test_mesh_device_vertex_pct(monkeypatch, counters, share):
    monkeypatch.setattr(stage_timer, "counters", lambda: dict(counters))
    assert read(ctx_of()) == share


def test_mesh_device_vertex_pct_is_in_the_benchmark(monkeypatch):
    entry, = [m for m in Bench(ROOT).spec["per_layer"] if m["name"] == "mesh_device_vertex_pct"]
    assert entry == {"name": "mesh_device_vertex_pct", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "mvs/mesh.py",
                     "moves": "dense_s_per_set",
                     "workloads": ["grid-sift-flann-sgm.dense-1080p"]}
    monkeypatch.delattr(stage_timer, "counters")
    assert read(ctx_of()) is None
