"""The readers of the program's spans and counters inside "sfm" and "mesh"
(metrics/), on a hand-built context with the program's recorder stubbed:
their arithmetic on given spans, counters and device events, and None
where a span, a counter or the recorder's readers are missing."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench.manifest import Bench  # noqa: E402
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer  # noqa: E402

SPAN_METRICS = {
    "match_s": "match", "pair_ratio_s": "pair ratios", "pair_pose_s": "pair pose",
    "pnp_s": "pnp", "tracks_s": "tracks", "ba_s": "ba",
    "mesh_backproject_s": "mesh backproject", "mesh_cluster_s": "mesh cluster",
    "mesh_components_s": "mesh components", "mesh_holes_s": "mesh holes",
    "mesh_smooth_s": "mesh smooth", "fusion_write_s": "fusion write",
    "texture_write_s": "texture write",
}
COUNTER_METRICS = ("lm_iters_per_set", "sfm_starts_per_set", "ba_ms_per_lm_iter",
                   "ba_busy_pct", "ba_kernels_per_lm_iter")
MS = 1_000_000  # ns


def read(metric: str, ctx: dict):
    return Bench(ROOT).reader(metric)(ctx)


def ctx_of(stages=None, events=(), sets=4) -> dict:
    return {"stages": dict(stages or {}), "events": list(events), "sets": sets,
            "lo": 0, "hi": 10_000 * MS}


@pytest.fixture
def recorded(monkeypatch):
    """Stub the recorder's counters() and spans() with the given ones."""

    def stub(counters=None, spans=()):
        monkeypatch.setattr(stage_timer, "counters", lambda: dict(counters or {}))
        monkeypatch.setattr(stage_timer, "spans", lambda: list(spans))

    return stub


@pytest.mark.parametrize("metric,span", sorted(SPAN_METRICS.items()))
def test_span_readers_give_seconds_a_set(metric, span):
    assert read(metric, ctx_of({span: 6.0, "sfm": 9.0}, sets=4)) == pytest.approx(1.5)
    assert read(metric, ctx_of({"sfm": 9.0})) is None


def test_counter_readers_give_counts_a_set(recorded):
    recorded({"lm iterations": 900, "sfm starts": 6})
    assert read("lm_iters_per_set", ctx_of(sets=4)) == 225.0
    assert read("sfm_starts_per_set", ctx_of(sets=4)) == 1.5
    recorded({"sfm starts": 4})
    assert read("lm_iters_per_set", ctx_of()) is None
    assert read("sfm_starts_per_set", ctx_of()) == 1.0


def test_ba_ms_per_lm_iter(recorded):
    recorded({"lm iterations": 250})
    assert read("ba_ms_per_lm_iter", ctx_of({"ba": 4.5})) == pytest.approx(18.0)
    assert read("ba_ms_per_lm_iter", ctx_of({"sfm": 4.5})) is None
    recorded({"lm iterations": 0})
    assert read("ba_ms_per_lm_iter", ctx_of({"ba": 4.5})) is None
    recorded({})
    assert read("ba_ms_per_lm_iter", ctx_of({"ba": 4.5})) is None


# two "ba" spans of 100 ms and 50 ms; events: a kernel wholly inside the
# first (20 ms), a copy across its end (10 ms inside), a kernel overlapping
# the first one (5 ms more of union), a kernel between the spans, a kernel
# starting before the second and ending in it (15 ms inside), a set inside
# the second (5 ms), and one after both
SPANS = [("ba", 100 * MS, 200 * MS, None), ("match", 0, 90 * MS, None),
         ("ba", 300 * MS, 350 * MS, None)]
EVENTS = [
    ("ba_kernel_a", 110 * MS, 130 * MS),
    ("ba_kernel_b", 125 * MS, 135 * MS),
    ("Memcpy DtoH (Device -> Pageable)", 190 * MS, 210 * MS),
    ("between", 250 * MS, 260 * MS),
    ("early", 280 * MS, 315 * MS),
    ("Memset (Device)", 320 * MS, 325 * MS),
    ("ba_kernel_c", 330 * MS, 331 * MS),
    ("after", 400 * MS, 410 * MS),
]


def test_ba_busy_pct_is_the_union_clipped_to_the_ba_spans(recorded):
    recorded({"lm iterations": 2}, SPANS)
    busy_ms = (135 - 110) + (200 - 190) + (315 - 300) + 5 + 1
    assert read("ba_busy_pct", ctx_of(events=EVENTS)) == pytest.approx(100.0 * busy_ms / 150)
    assert read("ba_busy_pct", ctx_of(events=[])) is None
    recorded({"lm iterations": 2}, [s for s in SPANS if s[0] != "ba"])
    assert read("ba_busy_pct", ctx_of(events=EVENTS)) is None


def test_ba_kernels_per_lm_iter_counts_kernels_starting_in_ba_spans(recorded):
    recorded({"lm iterations": 2}, SPANS)
    # ba_kernel_a, ba_kernel_b, ba_kernel_c; not the copy, the set, nor
    # "early" (it starts before the second span)
    assert read("ba_kernels_per_lm_iter", ctx_of(events=EVENTS)) == pytest.approx(3 / 2)
    recorded({}, SPANS)
    assert read("ba_kernels_per_lm_iter", ctx_of(events=EVENTS)) is None
    recorded({"lm iterations": 2}, [])
    assert read("ba_kernels_per_lm_iter", ctx_of(events=EVENTS)) is None


@pytest.mark.parametrize("metric", COUNTER_METRICS)
def test_a_program_without_counters_or_spans_gives_none(metric, monkeypatch):
    """A recorder without counters() and spans(), as before they existed."""
    monkeypatch.delattr(stage_timer, "counters")
    monkeypatch.delattr(stage_timer, "spans")
    assert read(metric, ctx_of({"ba": 4.5}, events=EVENTS)) is None


def test_the_readers_read_what_the_program_records():
    """The recorder's own counters and spans, kept after enable(False), as
    the harness leaves them for its readers."""
    import time

    stage_timer.enable()
    try:
        with stage_timer.stage("ba"):
            time.sleep(0.01)
            stage_timer.count("lm iterations", 5)
        stage_timer.count("sfm starts")
    finally:
        stage_timer.enable(False)
    (_, a, b, _), = stage_timer.spans()
    ctx = ctx_of({"ba": stage_timer.report()["ba"][0]},
                 events=[("k", a + 1000, a + 2000), ("k", a + 3000, a + 4000)], sets=1)
    ctx["lo"], ctx["hi"] = a - MS, b + MS
    assert read("lm_iters_per_set", ctx) == 5 and read("sfm_starts_per_set", ctx) == 1
    assert read("ba_ms_per_lm_iter", ctx) == pytest.approx((b - a) / 1e6 / 5)
    assert read("ba_kernels_per_lm_iter", ctx) == pytest.approx(2 / 5)
    assert read("ba_busy_pct", ctx) == pytest.approx(100.0 * 2000 / (b - a))


def test_every_new_metric_is_in_the_benchmark_with_its_cell():
    bench = Bench(ROOT)
    layer = {m["name"]: m for m in bench.spec["per_layer"]}
    sparse, dense = "unordered-sift-bf.sparse-1080p", "grid-sift-flann-sgm.dense-1080p"
    for name in [*SPAN_METRICS, *COUNTER_METRICS]:
        m = layer[name]
        cell = dense if m["layer"] in ("mvs/mesh.py", "utils/ply.py") else sparse
        assert m["workloads"] == [cell], name
        assert m["moves"] == ("dense" if cell == dense else "sparse") + "_s_per_set"
        assert m["better"] == ("higher" if name == "ba_busy_pct" else "lower")
