"""The ORB deployment's additions, on the CPU: the configuration, cell and
metrics as BENCHMARK.json names them, and the new readers on hand-built
contexts (the program's recorder stubbed where they read it): the ORB
spans and the scene write as seconds a set, valid keypoints a view, and
K1's bf16 roofline share against a hand count of its bound."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench.manifest import Bench  # noqa: E402
from h100bench.reference.roofline import PEAK_BYTES_S, PEAK_FLOP_S  # noqa: E402
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer  # noqa: E402

CELL = "unordered-orb-bf.sparse-1080p"
SIFT = "unordered-sift-bf.sparse-1080p"
NEW = ["orb_detect_s", "orb_describe_s", "orb_keypoints_per_view", "scene_write_s",
       "k1_bf16_roofline_pct", "device_idle_pct.orb", "sfm_s.orb"]
# the shared sparse layers, read on ORB's tracks through their own readers
SHARED = ["features_s", "outputs_s", "match_s", "pair_ratio_s", "pair_pose_s", "pnp_s",
          "tracks_s", "ba_s", "ba_ms_per_lm_iter", "lm_iters_per_set", "sfm_starts_per_set",
          "ba_busy_pct", "ba_kernels_per_lm_iter", "ba_graph_iter_pct"]


def read(metric: str, ctx: dict):
    return Bench(ROOT).reader(metric)(ctx)


def test_the_configuration_and_cell_load_by_name():
    bench = Bench(ROOT)
    assert "unordered-orb-bf" in bench.configs and CELL in bench.cells
    cell = bench.cells[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("unordered-orb-bf",
                                                                "sparse-1080p", 1)
    cfg = bench.config("unordered-orb-bf")
    script = cfg["script"].split()
    assert [a for a in script if not a.startswith(("-Prun=", "-Pimage=", "-Pout="))
            and a != "--artifacts"] == cfg["flags"]
    assert "-Pfeature-detector=ORB" in cfg["flags"] and "-Pfeature-limit=0" in cfg["flags"]
    assert cfg["images"] == {"views": 12, "width": 1920, "height": 1080, "f": 1680.0}
    assert list(cfg["reduced"]) == ["artifacts"] and cfg["guarantees"]
    assert bench.traffic("sparse-1080p")["job"] == "sparse"
    assert set(bench.limits(CELL)) == {"views_missing", "ate_pct"}
    assert bench.limits(CELL)["views_missing"] == 0


def test_the_cell_reports_its_metrics():
    bench = Bench(ROOT)
    assert [m["name"] for m in bench.metrics(CELL, False)] == ["sparse_s_per_set", "setup_s"]
    on_cell = [m["name"] for m in bench.metrics(CELL, True)]
    assert set(NEW) | {f"{q}.orb" for q in SHARED} <= set(on_cell)
    assert not {"k1_roofline_pct", "device_idle_pct.sparse", "sfm_s"} & set(on_cell)
    assert "scene_write_s" in [m["name"] for m in bench.metrics(SIFT, True)]
    assert bench.reader_path("device_idle_pct.orb").endswith("metrics/device_idle_pct.py")
    assert bench.reader_path("sfm_s.orb").endswith("metrics/sfm_s.py")
    layers = {m["name"]: m["layer"] for m in bench.spec["per_layer"]}
    assert layers["k1_bf16_roofline_pct"] == layers["k1_roofline_pct"]
    assert layers["sfm_s.orb"] == layers["sfm_s"]
    for q in SHARED:
        assert bench.reader_path(f"{q}.orb") == bench.reader_path(q)
        assert q == "features_s" or layers[f"{q}.orb"] == layers[q]
    assert layers["features_s.orb"] == layers["orb_detect_s"]


@pytest.mark.parametrize("metric,span", [("orb_detect_s", "orb detect"),
                                         ("orb_describe_s", "orb describe"),
                                         ("scene_write_s", "scene write"),
                                         ("sfm_s.orb", "sfm")])
def test_span_readers_give_seconds_a_set(metric, span):
    assert read(metric, {"stages": {span: 6.0, "features": 9.0}, "sets": 4}) == pytest.approx(1.5)
    assert read(metric, {"stages": {"features": 9.0}, "sets": 4}) is None


def test_keypoints_a_view(monkeypatch):
    ctx = {"sets": 4, "config": {"images": {"views": 12}}}
    monkeypatch.setattr(stage_timer, "counters",
                        lambda: {"orb keypoints": 4 * 12 * 6500, "orb slots": 4 * 12 * 65536})
    assert read("orb_keypoints_per_view", ctx) == 6500.0
    monkeypatch.setattr(stage_timer, "counters", lambda: {})
    assert read("orb_keypoints_per_view", ctx) is None


def _scene(path, counts, capacity=4096, D=256):
    valid = np.zeros((len(counts), capacity), bool)
    for s, n in enumerate(counts):
        valid[s, :n] = True
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "scene.npz"), feat_valid=valid,
             descriptors=np.ones((len(counts), capacity, D), np.float32))
    return str(path)


def test_k1_bf16_roofline_against_a_hand_count(tmp_path):
    """Two sets of three shots (1,000 / 2,000 / 3,000 and 500 / 500 / 500
    valid), all pairs, D = 256 at 2 bytes: each set's bound is the larger
    of 2 D sum(n_a n_b) over 989 TFLOP/s and the bytes (each valid value
    once, 12 bytes a valid query of each pair) over 3.35 TB/s."""
    a = _scene(tmp_path / "a", [1000, 2000, 3000])
    b = _scene(tmp_path / "b", [500, 500, 500])
    flops_a = 2 * 256 * (1000 * 2000 + 1000 * 3000 + 2000 * 3000)  # 5.632e9
    bytes_a = 6000 * 256 * 2 + 12 * (1000 + 1000 + 2000)  # 3,120,000
    flops_b = 2 * 256 * 3 * 500 * 500  # 3.84e8
    bytes_b = 1500 * 256 * 2 + 12 * 1500  # 786,000
    least = (max(flops_a / PEAK_FLOP_S["bf16"], bytes_a / PEAK_BYTES_S)
             + max(flops_b / PEAK_FLOP_S["bf16"], bytes_b / PEAK_BYTES_S))
    spent = int(round(4 * least * 1e9))  # the kernel at a quarter of its bound's rate
    events = [("void two_nn_bf16_kernel(...)", 0, spent // 2),
              ("void two_nn_f32_kernel(...)", 0, 10 ** 9),
              ("aten::copy", 0, 10 ** 9),
              ("void two_nn_bf16_kernel(...)", 10 ** 9, 10 ** 9 + spent - spent // 2)]
    ctx = {"config": {"flags": ["-Pfeature-detector=ORB", "-Pfeature-matcher=BF"]},
           "events": events, "sets": 2, "outputs": [a, b]}
    assert read("k1_bf16_roofline_pct", ctx) == pytest.approx(25.0, rel=1e-4)  # whole ns
    assert read("k1_bf16_roofline_pct", dict(ctx, events=events[1:3])) is None
    assert read("k1_bf16_roofline_pct", dict(ctx, outputs=[])) is None
    assert read("k1_roofline_pct", ctx) is None  # the fp32 reader leaves ORB out


def test_the_scene_write_reader_reads_what_the_program_records(tmp_path):
    from sfm_mvs_pipeline_tpu_torch.models.scene import Scene
    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import save_scene

    scene = Scene.create(["a.jpg", "b.jpg"], (64, 48), np.zeros((2, 8, 2)), np.ones((2, 8, 256)),
                         np.ones((2, 8), bool), np.array([50.0, 32, 24, 0, 0, 0, 0]))
    stage_timer.enable()
    try:
        save_scene(scene, str(tmp_path / "scene.npz"))
        save_scene(scene, str(tmp_path / "again.npz"))
    finally:
        stage_timer.enable(False)
    stages = {k: v[0] for k, v in stage_timer.report().items()}
    assert read("scene_write_s", {"stages": stages, "sets": 2}) == pytest.approx(
        stages["scene write"] / 2)


def test_the_control_puts_the_reference_in_bfloat16_in_the_front_ends_place():
    """orb_control.py's front end: plain_orb in bfloat16 where the CLI looks
    up ops.orb.orb_features, its floats widened to float32 and each a
    bfloat16 value; the program's own function is back afterwards."""
    import torch

    from h100bench.orb_control import front_end_in
    from sfm_mvs_pipeline_tpu_torch.ops import orb

    own = orb.orb_features
    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (1, 96, 128), np.uint8))
    with front_end_in(torch.bfloat16):
        out = orb.orb_features(img.float() / 255.0, max_features=128)
    assert orb.orb_features is own
    assert out["descriptors"].dtype == torch.uint8 and out["valid"].dtype == torch.bool
    kp = out["keypoints"][out["valid"]]
    assert kp.dtype == torch.float32 and len(kp) > 0
    assert torch.equal(kp, kp.to(torch.bfloat16).to(torch.float32))
    from h100bench import plain_orb

    assert not torch.equal(out["keypoints"], plain_orb.orb(img.float() / 255.0, 128)["keypoints"])


def test_retriangulation_under_true_cameras_recovers_exact_tracks():
    """retriangulate.py: points on the render's plane seen exactly by three
    of its true cameras come back to 1e-9 with no reprojection error; one
    observation moved by 2 px moves its point and shows as error."""
    from h100bench.reference.geometry import true_cameras
    from h100bench.retriangulate import triangulate

    R, C = true_cameras(3)
    w, h, f = 384, 216, 336.0
    X = np.array([[0.3, 0.1, 10.0], [1.0, -0.2, 10.0], [0.7, 0.4, 10.0]])
    cam = np.einsum("sij,psj->psi", R, X[:, None] - C[None])
    uv = np.stack([f * cam[..., 0] / cam[..., 2] + w / 2, f * cam[..., 1] / cam[..., 2] + h / 2], -1)
    scene = {"keypoints": uv.transpose(1, 0, 2), "point_valid": np.ones(3, bool),
             "obs_point": np.repeat(np.arange(3), 3), "obs_shot": np.tile(np.arange(3), 3),
             "obs_feat": np.repeat(np.arange(3), 3), "obs_w": np.ones(9, np.float32)}
    got, err = triangulate(scene, R, C, w, h, f)
    np.testing.assert_allclose(got, X, atol=1e-9)
    assert err.max() < 1e-6
    scene["keypoints"] = scene["keypoints"].copy()
    scene["keypoints"][1, 0, 0] += 2.0
    got, err = triangulate(scene, R, C, w, h, f)
    assert np.abs(got[0] - X[0]).max() > 1e-3 and err.max() > 0.5
    np.testing.assert_allclose(got[1:], X[1:], atol=1e-9)
