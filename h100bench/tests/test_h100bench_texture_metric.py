"""The readers of texture_atlas_s (metrics/texture_atlas_s.py) and
texture_device_face_pct (metrics/texture_device_face_pct.py) on hand-built
contexts with the program's counters stubbed: the span "texture atlas" in
seconds a set, the share of textured faces sampled on a card, None where
the span, the counters or the recorder's readers are missing, and their
entries in BENCHMARK.json, on both dense cells."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench.manifest import Bench  # noqa: E402
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer  # noqa: E402

MS = 1_000_000  # ns
DENSE = ["grid-sift-flann-sgm.dense-1080p", "grid-sift-flann-pm.dense-pm-1080p"]


def read(metric: str, ctx: dict):
    return Bench(ROOT).reader(metric)(ctx)


def ctx_of(stages=None) -> dict:
    return {"stages": dict(stages or {}), "events": [], "sets": 4, "lo": 0, "hi": 10_000 * MS}


def test_texture_atlas_s_gives_seconds_a_set():
    assert read("texture_atlas_s", ctx_of({"texture atlas": 0.6, "texture": 9.0})) == \
        pytest.approx(0.15)
    assert read("texture_atlas_s", ctx_of({"texture": 9.0})) is None  # a program without it


@pytest.mark.parametrize("counters,share", [
    ({"texture faces": 1_200_000, "texture device faces": 1_200_000}, 100.0),
    ({"texture faces": 400}, 0.0),  # textured on the CPU
    ({"texture faces": 0}, None),
    ({"texture device faces": 400}, None),
    ({}, None),  # a program without the counters
])
def test_texture_device_face_pct(monkeypatch, counters, share):
    monkeypatch.setattr(stage_timer, "counters", lambda: dict(counters))
    assert read("texture_device_face_pct", ctx_of()) == share


def test_the_texture_metrics_are_in_the_benchmark(monkeypatch):
    bench = Bench(ROOT)
    entries = {m["name"]: m for m in bench.spec["per_layer"]}
    assert entries["texture_atlas_s"] == {
        "name": "texture_atlas_s", "unit": "s/set", "better": "lower", "source": "program_span",
        "layer": "mvs/texture.py", "moves": "dense_s_per_set", "workloads": DENSE}
    assert entries["texture_device_face_pct"] == {
        "name": "texture_device_face_pct", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "mvs/texture.py", "moves": "dense_s_per_set",
        "workloads": DENSE}
    for cell in DENSE:
        on_cell = [m["name"] for m in bench.metrics(cell, True)]
        assert on_cell[-2:] == ["texture_atlas_s", "texture_device_face_pct"]
    monkeypatch.delattr(stage_timer, "counters")
    assert read("texture_device_face_pct", ctx_of()) is None
