"""The port's span-and-counter recorder (utils/stage_timer.py) and the spans
and counters of the sparse and mesh paths, on the CPU.

Spans nest and keep each name's total apart; nothing is recorded while
the recorder is off, and enable(False) keeps what it holds; shard threads'
counters add up and their spans carry their shard; a span never
synchronises a card, and its clock is the one torch.profiler stamps its
events with. A small reconstruct (insel at 240x135, ORB, seed 0: its first
start is abandoned, tests/test_torch_sfm_restart.py) reports the six sparse
spans, an "lm iterations" counter equal to its logged BA iterations and an
"sfm starts" counter equal to its attempts; mesh_from_depth_maps reports
the five mesh spans and counts its raw vertices in "mesh raw vertices"
("mesh device vertices" stays 0 on the CPU); build_texture_atlas counts its
faces in "texture faces" ("texture device faces" stays 0 on the CPU). The CLI's ORB branch reports "orb detect" and "orb
describe" inside "features" and the counters "orb keypoints" and "orb
slots" (SIFT none of them), and the scene checkpoint is written under
"scene write".
"""

import os
import re
import time

import cv2
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

torch.set_num_threads(2)

INSEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_data",
                     "insel")
SPARSE_SPANS = {"match", "pair ratios", "pair pose", "pnp", "tracks", "ba"}
MESH_SPANS = {"mesh backproject", "mesh cluster", "mesh components", "mesh holes", "mesh smooth"}


@pytest.fixture
def recorder():
    stage_timer.enable()
    try:
        yield stage_timer
    finally:
        stage_timer.enable(False)


class NoHostValue:
    """A stand-in for a device value: reading it as a number raises."""

    def __index__(self):
        raise AssertionError("read as a host value")

    __int__ = __bool__ = __float__ = __index__


def test_spans_nest_and_outer_totals_are_unchanged(recorder):
    with recorder.stage("outer"):
        time.sleep(0.01)
        with recorder.stage("inner"):
            time.sleep(0.02)
        with recorder.stage("inner"):
            pass
    spans = {}
    for name, t0, t1, shard in recorder.spans():
        spans.setdefault(name, []).append((t0, t1))
        assert shard is None
    (o0, o1), = spans["outer"]
    assert all(o0 <= a <= b <= o1 for a, b in spans["inner"])
    total, calls = recorder.report()["outer"]
    assert calls == 1 and total == (o1 - o0) / 1e9 and total >= 0.03
    inner, calls = recorder.report()["inner"]
    assert calls == 2 and inner == pytest.approx(sum(b - a for a, b in spans["inner"]) / 1e9)
    assert 0.02 <= inner < total


def test_nothing_is_recorded_while_off():
    stage_timer.enable()
    stage_timer.enable(False)
    with stage_timer.stage("off"):
        stage_timer.count("off")
        stage_timer.count("off", NoHostValue())  # off, the value is never looked at
    assert stage_timer.report() == {} and stage_timer.counters() == {}
    assert stage_timer.spans() == []


def test_count_takes_host_integers_only(recorder):
    recorder.count("n", 2)
    recorder.count("n", np.int64(3))
    recorder.count("n")
    with pytest.raises(TypeError):
        recorder.count("n", NoHostValue())
    with pytest.raises(TypeError):
        recorder.count("n", torch.tensor(1))
    assert recorder.counters() == {"n": 6}


def test_disable_keeps_everything_until_the_next_enable():
    stage_timer.enable()
    with stage_timer.stage("kept"):
        stage_timer.count("kept", 3)
    stage_timer.enable(False)
    assert set(stage_timer.report()) == {"kept"} and stage_timer.counters() == {"kept": 3}
    assert [s[0] for s in stage_timer.spans()] == ["kept"]
    stage_timer.enable()
    try:
        assert stage_timer.report() == {} and stage_timer.counters() == {}
        assert stage_timer.spans() == []
    finally:
        stage_timer.enable(False)


def test_shard_threads_counters_sum_and_spans_carry_their_shard(recorder):
    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards

    def one(sh):
        with recorder.stage("shard work"):
            recorder.count("shard items", sh.index + 1)
            time.sleep(0.01)

    Shards("cpu,cpu,cpu,cpu").run(one)
    assert recorder.counters() == {"shard items": 1 + 2 + 3 + 4}
    assert sorted(s[3] for s in recorder.spans() if s[0] == "shard work") == [0, 1, 2, 3]
    assert recorder.report()["shard work"][1] == 4


def test_many_threads_lose_no_count_or_span(recorder):
    """More threads than cores, switching often: no update is lost."""
    import sys
    import threading

    n_threads, n_each = 4 * (os.cpu_count() or 1), 500
    parts = []

    def work(shard):
        with recorder.shard_thread(parts, shard):
            for _ in range(n_each):
                with recorder.stage("tick"):
                    recorder.count("ticks")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    recorder.merge(parts)
    assert recorder.counters() == {"ticks": n_threads * n_each}
    assert len(recorder.spans()) == n_threads * n_each
    assert recorder.report()["tick"][1] == n_threads * n_each


def test_stage_never_synchronises(recorder, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("stage() synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", refuse, raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    with recorder.stage("plain"):
        pass
    parts = []
    with recorder.shard_thread(parts, 0), recorder.stage("in a shard"):
        pass
    recorder.merge(parts)
    assert set(recorder.report()) == {"plain", "in a shard"}


def test_a_span_holds_a_profiler_range_entered_inside_it(recorder):
    """The spans' clock is the profiler's: a record_function range entered
    inside a span lies inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.stage("around"):
            time.sleep(0.005)
            with record_function("probe inside"):
                time.sleep(0.01)
            time.sleep(0.005)
    (_, t0, t1, _), = recorder.spans()
    probes = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name() == "probe inside"]
    assert len(probes) == 1
    a, b = probes[0]
    assert t0 <= a < b <= t1, (t0, a, b, t1)


@pytest.fixture(scope="module")
def insel_orb(tmp_path_factory):
    """insel cut to 240x135, ORB at capacity 1,024 (as
    tests/test_torch_sfm_restart.py)."""
    from sfm_mvs_pipeline_tpu_torch.ops.matching import expand_binary_descriptors
    from sfm_mvs_pipeline_tpu_torch.ops.orb import orb_features
    from sfm_mvs_pipeline_tpu_torch.utils.images import list_images, load_gray_batch

    data = tmp_path_factory.mktemp("insel_small")
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        cv2.imwrite(str(data / name), cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA))
    paths = list_images(str(data))
    imgs, _ = load_gray_batch(paths)
    f = orb_features(torch.from_numpy(imgs), max_features=1024)
    return (paths, f["keypoints"].numpy(), expand_binary_descriptors(f["descriptors"]).numpy(),
            f["valid"].numpy())


def test_reconstruct_reports_the_sparse_spans_and_counters(insel_orb, recorder, monkeypatch):
    """Besides, every span ends without an exception, an abandoned start's
    too: a wrapper that, like the benchmark's, keeps only spans that end
    normally sees each of them."""
    import contextlib

    from sfm_mvs_pipeline_tpu_torch.cli.photogrammetrie import _normalize_camera_model
    from sfm_mvs_pipeline_tpu_torch.models.cameras import make_intrinsics
    from sfm_mvs_pipeline_tpu_torch.models.scene import Scene
    from sfm_mvs_pipeline_tpu_torch.ops.pairs import make_pairs
    from sfm_mvs_pipeline_tpu_torch.sfm import incremental as I

    paths, kps, descs, valid = insel_orb
    intr = make_intrinsics(240, 135).numpy().astype(np.float64)
    scene = Scene.create(paths, (240, 135), kps, descs, valid, intr,
                         camera_model=_normalize_camera_model("simple-radial"))
    ended = []

    @contextlib.contextmanager
    def kept_on_a_normal_end(name):
        with recorder.stage(name):
            yield
        ended.append(name)

    monkeypatch.setattr(I, "stage", kept_on_a_normal_end)
    logs = []
    with recorder.stage("sfm"):
        stats = I.reconstruct(scene, make_pairs("unordered", 3),
                              I.SfMConfig(seed=0, binary_descriptors=True), log=logs.append,
                              device="cpu")
    assert stats["views"] == 3 and stats["attempts"] >= 2
    report = recorder.report()
    assert SPARSE_SPANS <= set(report), sorted(report)
    assert sum(report[k][0] for k in SPARSE_SPANS) <= report["sfm"][0]
    iters = [int(m) for line in logs for m in re.findall(r"^BA #\d+: .*\((\d+) iters", line)]
    assert len(iters) == sum(1 for s in recorder.spans() if s[0] == "ba") > stats["ba_runs"]
    assert sorted(ended) == sorted(s[0] for s in recorder.spans() if s[0] != "sfm")
    solves = sum(1 for s in recorder.spans() if s[0] == "pnp")  # a "pnp" span a solve
    assert solves > 0
    assert recorder.counters() == {"lm iterations": sum(iters), "sfm starts": stats["attempts"],
                                   "pnp solves": solves, "pnp gn steps": 10 * solves}


def test_mesh_from_depth_maps_reports_the_mesh_spans(recorder):
    from sfm_mvs_pipeline_tpu_torch.models.cameras import make_intrinsics
    from sfm_mvs_pipeline_tpu_torch.mvs.mesh import mesh_from_depth_maps

    h, w = 24, 32
    yy, xx = np.mgrid[0:h, 0:w]
    depth = (5.0 + 0.01 * xx + 0.02 * yy).astype(np.float32)
    depths = np.stack([depth, depth])
    valids = np.ones_like(depths, bool)
    valids[1, :4] = False
    poses = np.zeros((2, 6))
    poses[1, 3] = 0.2
    intr = make_intrinsics(w, h).numpy().astype(np.float32)
    logs = []
    with recorder.stage("mesh"):
        mesh = mesh_from_depth_maps(depths, valids, poses, intr, device="cpu", log=logs.append)
    assert len(mesh["faces"]) > 0
    report = recorder.report()
    assert MESH_SPANS <= set(report), sorted(report)
    assert all(report[k][1] == 1 for k in MESH_SPANS)
    assert sum(report[k][0] for k in MESH_SPANS) <= report["mesh"][0]
    raw, = [int(m.group(1)) for ln in logs if (m := re.match(r"raw mesh: (\d+) verts", ln))]
    assert raw > 0 and recorder.counters().get("mesh raw vertices") == raw
    assert not recorder.counters().get("mesh device vertices")  # clustered on the CPU


def test_build_texture_atlas_counts_its_faces(recorder):
    """build_texture_atlas counts its faces in "texture faces" at every
    call, those it sampled on a card in "texture device faces": none on the
    CPU (tests/test_torch_texture_gpu.py holds the card's count)."""
    from sfm_mvs_pipeline_tpu_torch.models.cameras import make_intrinsics
    from sfm_mvs_pipeline_tpu_torch.mvs.texture import build_texture_atlas

    h, w = 24, 32
    yy, xx = np.mgrid[0:4, 0:4]
    verts = np.stack([xx.ravel() * 0.1, yy.ravel() * 0.1, np.full(16, 5.0)], 1)
    a = (yy * 4 + xx)[:-1, :-1].ravel()
    faces = np.concatenate([np.stack([a, a + 4, a + 1], 1), np.stack([a + 1, a + 4, a + 5], 1)])
    images = np.random.default_rng(0).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    poses = np.zeros((2, 6))
    poses[1, 3] = -0.1
    intr = make_intrinsics(w, h).numpy().astype(np.float32)
    for _ in range(2):
        tex = build_texture_atlas(verts, faces, poses, intr, images, device="cpu")
    assert len(faces) == 18 and (tex["face_view"] >= 0).all()
    assert recorder.counters() == {"texture faces": 2 * len(faces)}


def _inside(spans, name, outer):
    """Every span `name` lies inside a span `outer` on the same clock."""
    outs = [(a, b) for n, a, b, _ in spans if n == outer]
    return all(any(a <= s and e <= b for a, b in outs) for n, s, e, _ in spans if n == name)


def test_orb_features_report_their_spans_and_counters(insel_orb, recorder):
    """The CLI's ORB branch (cli/photogrammetrie.py::_extract_features) at
    capacity 1,024 on the three insel views: "orb detect" (one a pyramid
    level, and the final selection) and "orb describe" (one a level, the
    packing and the +-1 expansion) inside "features"; counters "orb
    keypoints", the valid keypoints of all views, and "orb slots",
    capacity times views; the outputs those of a run with the recorder
    off."""
    from sfm_mvs_pipeline_tpu_torch.cli.photogrammetrie import _extract_features
    from sfm_mvs_pipeline_tpu_torch.utils.images import load_gray_batch

    paths, kps, descs, valid = insel_orb
    imgs, _ = load_gray_batch(paths)
    with recorder.stage("features"):
        got = _extract_features("orb", torch.from_numpy(imgs), 1024)
    report, spans = recorder.report(), recorder.spans()
    levels = report["orb detect"][1] - 1
    assert 3 <= levels <= 8 and report["orb describe"][1] == levels + 2, report
    assert report["orb detect"][0] + report["orb describe"][0] <= report["features"][0]
    assert _inside(spans, "orb detect", "features") and _inside(spans, "orb describe", "features")
    assert recorder.counters() == {"orb keypoints": int(valid.sum()), "orb slots": 3 * 1024}
    for a, b in zip(got, (kps, descs, valid)):
        np.testing.assert_array_equal(a, b)


def test_sift_features_report_no_orb_span_or_counter(insel_orb, recorder):
    from sfm_mvs_pipeline_tpu_torch.cli.photogrammetrie import _extract_features
    from sfm_mvs_pipeline_tpu_torch.utils.images import load_gray_batch

    imgs, _ = load_gray_batch(insel_orb[0])
    _extract_features("sift", torch.from_numpy(imgs), 512)
    assert not {"orb detect", "orb describe"} & set(recorder.report())
    assert recorder.counters() == {}


def test_the_scene_checkpoint_is_written_under_its_span(recorder, tmp_path):
    """save_scene (utils/checkpoint.py) under "scene write", inside the
    CLI's "outputs"; one span a write, none while the recorder is off."""
    from sfm_mvs_pipeline_tpu_torch.models.scene import Scene
    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import save_scene

    scene = Scene.create(["a.jpg", "b.jpg"], (64, 48), np.zeros((2, 8, 2)), np.ones((2, 8, 256)),
                         np.ones((2, 8), bool), np.array([50.0, 32, 24, 0, 0, 0, 0]))
    with recorder.stage("outputs"):
        save_scene(scene, str(tmp_path / "scene.npz"))
    assert recorder.report()["scene write"][1] == 1
    assert _inside(recorder.spans(), "scene write", "outputs")
    recorder.enable(False)
    save_scene(scene, str(tmp_path / "again.npz"))
    assert recorder.report()["scene write"][1] == 1
