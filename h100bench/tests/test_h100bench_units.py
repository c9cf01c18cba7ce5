"""The harness's arithmetic on known inputs: the window rule on a fake
clock, the K1 bound, the card's busy and idle share on synthetic intervals,
and the geometry the check compares with."""

import os
import sys

import cv2
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import checks, control, trace  # noqa: E402
from h100bench.inputs import unit_of, warm_texture  # noqa: E402
from h100bench.manifest import Bench  # noqa: E402
from h100bench.reference import geometry as G  # noqa: E402
from h100bench.reference.pairs import pairs_of  # noqa: E402
from h100bench.reference.roofline import PEAK_BYTES_S, PEAK_FLOP_S, two_nn_bound  # noqa: E402
from h100bench.run import window  # noqa: E402


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seconds,durations,sets,elapsed", [
    (7.0, [3.0] * 9, 3, 9.0),   # starts at 0, 3, 6; the one started at 6 finishes at 9
    (6.0, [3.0] * 9, 2, 6.0),   # a set may not start at the limit itself
    (0.0, [5.0] * 9, 1, 5.0),   # the first set always runs
    (10.0, [12.0, 1.0], 1, 12.0),  # a stall longer than the window still counts
])
def test_window_rule_on_a_fake_clock(seconds, durations, sets, elapsed):
    clock = FakeClock()
    started = []

    def job(i):
        started.append(clock.t - 100.0)
        clock.t += durations[i]

    n, took = window(job, seconds, clock)
    assert (n, took) == (sets, elapsed)
    assert all(s < seconds or i == 0 for i, s in enumerate(started))


def test_two_nn_bound_counts_valid_descriptors_of_each_pair():
    counts = np.array([1000, 2000, 3000])
    pairs = pairs_of([], 3)  # unordered: (0, 1), (0, 2), (1, 2)
    b = two_nn_bound(counts, pairs, 128, "fp32")
    flops = 2 * 128 * (1000 * 2000 + 1000 * 3000 + 2000 * 3000)
    nbytes = 6000 * 128 * 4 + 12 * (1000 + 1000 + 2000)
    assert b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(max(flops / PEAK_FLOP_S["fp32"], nbytes / PEAK_BYTES_S))
    assert len(pairs_of(["-Pfeature-sequence=3", "-Pfeature-gridlength=12"], 12)) == 21
    assert len(pairs_of([], 12)) == 66


def test_k1_roofline_reader(tmp_path):
    valid = np.zeros((3, 4096), bool)
    valid[0, :1000], valid[1, :2000], valid[2, :3000] = True, True, True
    np.savez_compressed(tmp_path / "scene.npz", feat_valid=valid,
                        descriptors=np.zeros((3, 4096, 128), np.float32))
    least = two_nn_bound([1000, 2000, 3000], pairs_of([], 3), 128, "fp32")["bound_s"]
    spent_ns = int(4 * least * 1e9)  # two sets, each at half its bound's rate
    events = [("void two_nn_f32_kernel<...>", 0, spent_ns // 2), ("aten::copy", 0, 10 ** 9),
              ("void two_nn_f32_kernel<...>", 10 ** 9, 10 ** 9 + spent_ns // 2)]
    ctx = {"config": {"flags": ["-Pfeature-detector=SIFT"]}, "events": events, "sets": 2,
           "outputs": [str(tmp_path)]}
    read = Bench(ROOT).reader("k1_roofline_pct")
    assert read(ctx) == pytest.approx(50.0, rel=1e-4)  # whole nanoseconds
    assert read(dict(ctx, events=events[1:2])) is None  # no K1 event: nothing to read


def test_busy_and_idle_share_on_synthetic_intervals():
    events = [("a", 0, 40), ("b", 30, 50), ("c", 60, 70), ("d", 90, 130), ("e", -20, -10)]
    assert trace.merged(events, 0, 100) == [[0, 50], [60, 70], [90, 100]]
    assert trace.busy_s(events, 0, 100) == pytest.approx(70e-9)
    ctx = {"events": events, "lo": 0, "hi": 100}
    assert Bench(ROOT).reader("device_idle_pct.sparse")(ctx) == pytest.approx(30.0)
    assert Bench(ROOT).reader("device_idle_pct.dense")(dict(ctx, events=[])) is None
    spans = [("sfm", 0, 100), ("mesh", 52, 58), ("mesh", 70, 90)]
    assert trace.idle_gaps(events, spans, 0, 100) == [["mesh", pytest.approx(30e-9)]]
    assert trace.idle_gaps(events, spans[:2], 0, 100) == [["sfm", pytest.approx(20e-9)],
                                                         ["mesh", pytest.approx(10e-9)]]
    assert trace.idle_gaps(events, [], 0, 100) == [["no stage", pytest.approx(30e-9)]]
    assert trace.by_name([("k", 0, 10), ("j", 0, 30), ("k", 40, 50)]) == [["j", 30e-9],
                                                                        ["k", 20e-9]]


def test_true_cameras_are_the_renderer_s(tmp_path):
    from h100bench.reference.synth import render_views

    _, gt_R, gt_C = render_views(str(tmp_path), 12, 8, 8, 7.0, seed=5)
    R, C = G.true_cameras(12)
    np.testing.assert_allclose(R, gt_R, atol=1e-15)
    np.testing.assert_allclose(C, gt_C, atol=1e-15)


def test_surface_geometry():
    R, C = G.true_cameras(12)
    samples = G.surface_samples(R, C, 480, 270, 420.0, 8)
    assert G.off_surface_pct(samples) == 0.0
    assert G.uncovered_pct(samples, samples) == 0.0
    assert G.off_surface_pct(samples * 1.02) == 100.0
    half = samples[samples[:, 0] < np.median(samples[:, 0])]
    assert 45.0 < G.uncovered_pct(half, samples) < 55.0
    assert G.uncovered_pct(np.empty((0, 3)), samples) == 100.0
    assert G.off_surface_pct(np.empty((0, 3))) == 100.0
    s, Rs, t = 2.5, G.aa_to_rotmat(np.array([0.1, -0.2, 0.3])), np.array([1.0, 2.0, 3.0])
    est_R, est_C = R @ Rs, (C - t) @ Rs / s  # a similarity away from the truth
    s2, R2, t2 = G.sim3_from_cameras(est_R, est_C, R, C)
    np.testing.assert_allclose([s2, *R2.ravel(), *t2], [s, *Rs.ravel(), *t], atol=1e-9)


def test_checks_on_exact_answers_and_the_control(tmp_path):
    """The reference's own answers in float64 pass every number; in the
    precision below each cell's they fail one."""
    scale = {"views": 12, "width": 480, "height": 270, "f": 420.0}
    R, C = G.true_cameras(12)
    for kind, cell in (("sparse", "unordered-sift-bf.sparse-1080p"),
                       ("dense", "grid-sift-flann-sgm.dense-1080p")):
        truth = checks.truth_of(kind, R, C, scale, 7)
        limits = Bench(ROOT).limits(cell)
        exact = tmp_path / f"{kind}-f64"
        control.reference_outputs(str(exact), scale, 7, kind, "float64", "cpu")
        ok, worst = checks.judge([checks.CHECKS[kind](str(exact), truth)], limits)
        assert ok, worst
        low = tmp_path / f"{kind}-low"
        control.reference_outputs(str(low), scale, 7, kind, control.BELOW[kind], "cpu")
        ok, worst = checks.judge([checks.CHECKS[kind](str(low), truth)], limits)
        assert not ok, worst
    assert checks.judge([{}], {"ate_pct": 1.0}) == (False, {})


def test_surface_gray_is_the_render_s(tmp_path):
    from h100bench.reference.synth import render_views

    paths, R, C = render_views(str(tmp_path), 4, 90, 160, 140.0, seed=5)
    gray = G.surface_gray(G.surface_samples(R, C, 160, 90, 140.0, 1), G.true_textures(5))
    img = np.concatenate([cv2.imread(p, cv2.IMREAD_GRAYSCALE).ravel() for p in paths])
    assert not np.isnan(gray).any()
    assert np.median(np.abs(gray - img)) < 2.0  # JPEG at quality 95
    assert np.corrcoef(gray, img)[0, 1] > 0.99
    assert np.isnan(G.surface_gray(np.array([[0.0, 0.0, 8.5]]), G.true_textures(5))).all()


def test_dup_pct():
    pts = np.array([[1.0, 2.0, 3.0], [1.0, 2.0, 3.0], [1.0, 2.0, 3.5], [1.0, 2.0, 3.0]])
    assert G.dup_pct(pts) == 50.0
    assert G.dup_pct(pts[1:3]) == 0.0
    assert G.dup_pct(np.empty((0, 3))) == 100.0


def test_texture_number_follows_the_atlas(tmp_path):
    """The control's textured mesh at float64 reads near 0; its atlas
    blanked, or judged against another seed's textures, reads 100."""
    scale = {"views": 4, "width": 320, "height": 180, "f": 280.0}
    R, C = G.true_cameras(4)
    out = str(tmp_path / "mesh")
    control.reference_outputs(out, scale, 7, "dense", "float64", "cpu")
    truth = checks.truth_of("dense", R, C, scale, 7)
    assert checks.check_dense(out, truth)["texture_uncorr_pct"] < 1.0
    other = checks.truth_of("dense", R, C, scale, 8)
    assert checks.check_dense(out, other)["texture_uncorr_pct"] > 90.0
    atlas = cv2.imread(os.path.join(out, "mesh_dense.png"))
    cv2.imwrite(os.path.join(out, "mesh_dense.png"), np.full_like(atlas, 128))
    assert checks.check_dense(out, truth)["texture_uncorr_pct"] == 100.0
    os.remove(os.path.join(out, "mesh_dense.png"))
    with pytest.raises(ValueError):
        checks.check_dense(out, truth)


def test_textured_mesh_reader_reads_the_program_s_writer(tmp_path):
    from sfm_mvs_pipeline_tpu_torch.mvs.texture import write_ply_mesh_textured

    rng = np.random.default_rng(0)
    verts = rng.normal(size=(40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (30, 3))
    uv = rng.random((30, 3, 2)).astype(np.float32)
    atlas = rng.integers(0, 255, (16, 24, 3)).astype(np.uint8)
    path = str(tmp_path / "mesh_dense.ply")
    write_ply_mesh_textured(path, verts, faces, uv, atlas,
                            colors=rng.integers(0, 255, (40, 3)).astype(np.uint8))
    v, f, t, a = checks.read_textured_mesh(path)
    np.testing.assert_array_equal(v, verts.astype(np.float64))
    np.testing.assert_array_equal(f, faces)
    np.testing.assert_array_equal(t, uv)
    assert a.shape == (16, 24)
    x, y = np.array([3.0, 5.25]), np.array([7.0, 2.5])
    ref = [atlas[7, 3].astype(float) @ [0.299, 0.587, 0.114]]  # cv2's gray of RGB
    assert checks.bilinear(a, x[:1], y[:1])[0] == pytest.approx(ref[0], abs=1.0)


def test_a_unit_holds_every_listed_texture_in_an_order_from_the_seed():
    listed = {"textures": [11, 12, 13, 14]}
    orders = {tuple(unit_of(listed, seed)) for seed in (1, 2, 3, 2**31 + 5, 3_000_000_017)}
    assert all(sorted(o) == [11, 12, 13, 14] for o in orders) and len(orders) > 1
    assert unit_of(listed, 9) == unit_of(listed, 9)
    assert warm_texture(listed, 9) == 11
    assert unit_of({}, 2**64 + 3) == [3] and warm_texture({}, 5) == 5


def test_ply_reader_reads_the_program_s_writer(tmp_path):
    from sfm_mvs_pipeline_tpu_torch.utils.ply import write_ply_points

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    path = str(tmp_path / "p.ply")
    write_ply_points(path, pts, rng.integers(0, 255, (500, 3)).astype(np.uint8),
                     rng.normal(size=(500, 3)))
    xyz, faces = checks.read_ply(path)
    np.testing.assert_array_equal(xyz, pts.astype(np.float64))
    assert faces == 0
