"""The PatchMatch deployment's additions, on the CPU: the configuration,
cell and metrics as BENCHMARK.json names them; K3's bound
(reference/pm_roofline.py) against chip_smoke.py's and PERF.md's figures;
the new readers on hand-built contexts (the program's recorder stubbed);
and the faults of pm_faults.py planted in a whole run of the cell at a
small size, each of which has to come out not correct (several minutes).

The small run's limits are its own sound numbers with a quarter of room,
as tests/test_h100bench_faults.py sets them; at 1080p on the card each
fault fails the cell's own limits (PERF.md)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from h100bench import pm_faults  # noqa: E402
from h100bench.faults import FAULTS, planted  # noqa: E402
from h100bench.manifest import Bench  # noqa: E402
from h100bench.reference.pm_roofline import k3_bound, k3_bound_of_counts  # noqa: E402
from h100bench.run import run_cell  # noqa: E402
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer  # noqa: E402

CELL = pm_faults.PM
SGM = "grid-sift-flann-sgm.dense-1080p"
NEW = ["patchmatch_s", "consensus_s", "k3_roofline_pct", "pm_rect_view_pct", "fusion_s.pm",
       "mesh_s.pm", "texture_s.pm", "device_idle_pct.pm"]
MS = 1_000_000  # ns
SCALE = {"views": 6, "width": 384, "height": 216, "f": 336.0}
SEED = 7


def read(metric: str, ctx: dict):
    return Bench(ROOT).reader(metric)(ctx)


def test_the_configuration_and_cell_load_by_name():
    bench = Bench(ROOT)
    cell = bench.cells[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("grid-sift-flann-pm",
                                                                "dense-pm-1080p", 1)
    cfg, sgm = bench.config("grid-sift-flann-pm"), bench.config("grid-sift-flann-sgm")
    assert "-Pdense-method=patchmatch" in cfg["flags"] and "--sgm" not in cfg["flags"]
    # the set-up scene is the SGM cell's: the same flags less the dense ones
    assert ([a for a in cfg["flags"] if a not in cfg["dense_flags"]]
            == [a for a in sgm["flags"] if a not in sgm["dense_flags"]])
    assert cfg["images"] == sgm["images"] and list(cfg["reduced"]) == ["artifacts"]
    assert bench.traffic("dense-pm-1080p")["job"] == "dense"
    assert set(bench.limits(CELL)) == set(bench.limits(SGM))


def test_the_cell_reports_its_metrics():
    bench = Bench(ROOT)
    assert [m["name"] for m in bench.metrics(CELL, False)] == ["dense_s_per_set", "setup_s"]
    on_cell = [m["name"] for m in bench.metrics(CELL, True)]
    assert on_cell == NEW
    assert not set(NEW) & {m["name"] for m in bench.metrics(SGM, True)}
    layers = {m["name"]: m["layer"] for m in bench.spec["per_layer"]}
    for twin in ("fusion_s", "mesh_s", "texture_s"):
        assert bench.reader_path(f"{twin}.pm") == bench.reader_path(twin)
        assert layers[f"{twin}.pm"] == layers[twin]
    assert bench.reader_path("device_idle_pct.pm").endswith("metrics/device_idle_pct.py")


@pytest.mark.parametrize("parity,ms", [(None, 0.0758), (0, 0.0379), (1, 0.0379)])
def test_k3_bound_is_perf_mds_and_chip_smokes(parity, ms):
    got = k3_bound(6, 1080, 1920, 3, parity)
    assert got["bound_by"] == "operations"
    assert round(got["bound_s"] * 1e3, 4) == ms
    for shape in [(6, 1080, 1920, 3), (1, 1080, 1920, 3), (6, 270, 480, 2), (3, 7, 9, 4)]:
        want = chip_smoke.k3_bound(*shape, parity)
        mine = k3_bound(*shape, parity)
        assert mine["bound_s"] * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)
        assert mine["bound_by"] == want["bound_by"]


def counted(launches) -> dict:
    """The program's K3 counters after `launches` (C, H, W, r, parity)."""
    out = dict.fromkeys(("k3 candidate pixels", "k3 window samples", "k3 pixels", "k3 costs"), 0)
    for c, h, w, r, parity in launches:
        n_act = h * w if parity is None else (h * w + (1 - parity)) // 2
        out["k3 candidate pixels"] += c * n_act
        out["k3 window samples"] += c * n_act * (2 * r + 1) ** 2
        out["k3 pixels"] += h * w
        out["k3 costs"] += c * h * w
    return out


def test_k3_roofline_pct(monkeypatch):
    pair = [(1, 1080, 1920, 3, None)] + [(6, 1080, 1920, 3, p) for _ in range(8) for p in (0, 1)]
    counters = counted(pair * 60)
    monkeypatch.setattr(stage_timer, "counters", lambda: dict(counters))
    least = k3_bound_of_counts(*(counters[k] for k in ("k3 candidate pixels",
                                                      "k3 window samples", "k3 pixels",
                                                      "k3 costs")))["bound_s"]
    per_launch = 60 * (k3_bound(1, 1080, 1920, 3, None)["bound_s"]
                       + 8 * sum(k3_bound(6, 1080, 1920, 3, p)["bound_s"] for p in (0, 1)))
    assert least <= per_launch and least == pytest.approx(per_launch, rel=0.005)
    events = [("pm_score_kernel<3, true>", 0, 200 * MS), ("other_kernel", 0, 500 * MS)]
    ctx = {"events": events, "sets": 1}
    assert read("k3_roofline_pct", ctx) == pytest.approx(100.0 * least / 0.2)
    assert read("k3_roofline_pct", {"events": events[1:], "sets": 1}) is None
    monkeypatch.setattr(stage_timer, "counters", lambda: {})
    assert read("k3_roofline_pct", ctx) is None
    monkeypatch.delattr(stage_timer, "counters")
    assert read("k3_roofline_pct", ctx) is None


@pytest.mark.parametrize("counters,share", [
    ({"pm views": 12, "pm rect views": 12}, 100.0),
    ({"pm views": 4}, 0.0),  # every view took the warp-based route
    ({"pm views": 0}, None),
    ({}, None),  # a program without the counters
])
def test_pm_rect_view_pct(monkeypatch, counters, share):
    monkeypatch.setattr(stage_timer, "counters", lambda: dict(counters))
    assert read("pm_rect_view_pct", {"sets": 2}) == share


@pytest.mark.parametrize("metric,span", [("patchmatch_s", "patchmatch"),
                                         ("consensus_s", "consensus"),
                                         ("fusion_s.pm", "fusion"), ("texture_s.pm", "texture")])
def test_span_readers_give_seconds_a_set(metric, span):
    assert read(metric, {"stages": {span: 6.0, "dense": 9.0}, "sets": 4}) == pytest.approx(1.5)
    assert read(metric, {"stages": {"dense": 9.0}, "sets": 4}) is None


def _bench(tmp: str) -> str:
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(ROOT, "h100bench"), os.path.join(tmp, "h100bench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    path = os.path.join(tmp, "h100bench", "configs", "grid-sift-flann-pm.json")
    cfg = json.load(open(path))
    cfg["images"] = SCALE
    json.dump(cfg, open(path, "w"))
    return tmp


def _run(root: str) -> dict:
    return run_cell(root, CELL, SEED, 0, False, device="cpu", say=lambda msg: None)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = _bench(str(tmp_path_factory.mktemp("tiny-pm")))
    sound = _run(root)
    assert sound["attempted"] == 1 and sound["sets"][0]["numbers"]
    limits = {k: 1.25 * c["value"] for k, c in sound["checks"].items()}
    with open(os.path.join(root, "h100bench", "limits", f"{CELL}.json"), "w") as f:
        json.dump({"limits": limits}, f)
    assert _run(root)["correct"]
    pm_faults.register()
    return root


@pytest.mark.parametrize("fault", list(pm_faults.PM_FAULTS))
def test_a_broken_patchmatch_path_is_not_correct(tiny, fault):
    assert FAULTS[CELL] is pm_faults.PM_FAULTS
    with planted(CELL, fault, SCALE["views"]):
        result = _run(tiny)
    assert result["correct"] is False, (fault, result["checks"])
