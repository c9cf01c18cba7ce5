"""The port's dense modules against the JAX package, on the CPU in float32.

Inputs are made with numpy from a seed; the scene is tests/test_mvs.py's
two-plane render at 120x160. Tolerances, each with its reason:
  * box filter: atol 1e-4 on window sums up to ~49 (both sides take
    cumulative sums in f32, XLA and torch in their own order);
  * bilinear taps, WTA, consensus, back-projection: atol 1e-5 to 1e-6
    (the same f32 arithmetic; gathers are exact);
  * cost volumes: atol 2e-3 and a mean absolute difference under 1e-4
    (ZNCC divides by window variances of ~1e-3 on the blurred texture, and
    the variances come from the box sums above);
  * depth maps: where both are valid the median relative difference is
    <= 2e-4 (the parabola step reads those cost differences) and >= 98%
    of pixels agree on validity (a near-tie between two levels can flip the
    argmin when the volumes differ in the last bits);
  * plain SGM (the kernels' plain versions): atol 1e-6 against _scan_dir
    and the Pallas kernel in interpret mode, atol 1e-5 for the staged
    kernel on a bf16-exact grid (the tests/test_mvs.py bounds).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu.mvs import fusion as JF
from sfm_mvs_pipeline_tpu.mvs import plane_sweep as JP
from sfm_mvs_pipeline_tpu.mvs import rectified as JR
from sfm_mvs_pipeline_tpu.mvs import sgm as JS
from sfm_mvs_pipeline_tpu.ops.pallas.sgm_kernel import sgm_bidir_pallas, sgm_staged_hwd
from sfm_mvs_pipeline_tpu_torch.mvs import fusion as TF
from sfm_mvs_pipeline_tpu_torch.mvs import plane_sweep as TP
from sfm_mvs_pipeline_tpu_torch.mvs import rectified as TR
from sfm_mvs_pipeline_tpu_torch.mvs import sgm as TS
from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as TK
from tests.test_mvs import F, H, W, _render

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    centers = np.array([[-0.6, 0, 0], [-0.3, 0, 0], [0, 0, 0], [0.3, 0, 0], [0.6, 0, 0]])
    grays, gt = _render(rng, centers)
    poses = np.zeros((5, 6), np.float32)
    poses[:, 3:] = -centers
    poses[:, :3] = rng.normal(scale=0.002, size=(5, 3))  # small rotations: no identity shortcut
    intr = np.array([F, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    return grays, gt, poses, intr


def _agree(d_t, v_t, d_j, v_j):
    """(median relative depth difference where both are valid, share of
    pixels whose validity agrees)."""
    both = v_t & v_j
    assert both.mean() > 0.3
    rel = np.abs(d_t - d_j)[both] / np.abs(d_j[both])
    return float(np.median(rel)), float((v_t == v_j).mean())


@pytest.mark.parametrize("shape", [(17, 23), (2, 15, 31)])
def test_box_filter(shape):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    np.testing.assert_allclose(TP._box_filter(_t(x), 3).numpy(),
                               np.asarray(JP._box_filter(jnp.asarray(x), 3)), atol=1e-4)


def test_bilinear_hw():
    rng = np.random.default_rng(1)
    img = rng.random((20, 30)).astype(np.float32)
    x = rng.uniform(-3, 33, (7, 11)).astype(np.float32)
    y = rng.uniform(-3, 23, (7, 11)).astype(np.float32)
    vt, it = TP._bilinear_hw(_t(img), _t(x), _t(y))
    vj, ij = JP._bilinear_hw(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("masked", [False, True], ids=["best-half", "masked"])
def test_sweep_cost_volume(scene, masked):
    grays, _, poses, intr = scene
    planes = JP.make_depth_planes(6.0, 16.0, 24).astype(np.float32)
    nb = [1, 3, 0]
    ok = np.array([True, True, False]) if masked else None
    cv_t = TP.sweep_cost_volume(_t(grays[2]), _t(grays[nb]), _t(poses[2]), _t(poses[nb]),
                                _t(intr), _t(planes),
                                nbr_valid=None if ok is None else _t(ok))
    cv_j = JP.sweep_cost_volume(jnp.asarray(grays[2]), jnp.asarray(grays[nb]),
                                jnp.asarray(poses[2]), jnp.asarray(poses[nb]),
                                jnp.asarray(intr), jnp.asarray(planes),
                                nbr_valid=None if ok is None else jnp.asarray(ok))
    assert cv_t.shape == (24, H, W)
    np.testing.assert_allclose(cv_t.numpy(), np.asarray(cv_j), atol=2e-3)
    assert np.abs(cv_t.numpy() - np.asarray(cv_j)).mean() < 1e-4


def test_wta_depth():
    rng = np.random.default_rng(2)
    cv = rng.random((16, 20, 30)).astype(np.float32)
    planes = JP.make_depth_planes(2.0, 9.0, 16).astype(np.float32)
    out_t = TP.wta_depth(_t(cv), _t(planes), 0.2)
    out_j = JP.wta_depth(jnp.asarray(cv), jnp.asarray(planes), 0.2)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), rtol=1e-6)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))


@pytest.mark.parametrize("use_sgm", [False, True], ids=["wta", "sgm"])
def test_rectified_pair_depth(scene, use_sgm):
    grays, _, poses, intr = scene
    args = dict(n_levels=32, max_cost=0.35, use_sgm=use_sgm)
    d_t, c_t, v_t = TR.rectified_pair_depth(_t(grays[2]), _t(grays[3]), _t(poses[2]),
                                            _t(poses[3]), _t(intr), 6.0, 16.0, **args)
    d_j, c_j, v_j = JR.rectified_pair_depth(jnp.asarray(grays[2]), jnp.asarray(grays[3]),
                                            jnp.asarray(poses[2]), jnp.asarray(poses[3]),
                                            jnp.asarray(intr), 6.0, 16.0, **args)
    med, agree = _agree(d_t.numpy(), v_t.numpy(), np.asarray(d_j), np.asarray(v_j))
    assert med <= 2e-4 and agree >= 0.98, (med, agree)


def test_rectified_staged_sgm_route(scene, monkeypatch):
    """--sgm above STAGED_SGM_MIN_PIXELS (lowered here) takes the staged
    route: its 4-path sum equals the JAX package's staged kernel (interpret
    mode) on the same bf16-rounded volume, and its depth agrees with the
    unstaged route up to the bf16 rounding of the cost."""
    grays, _, poses, intr = scene
    seen = {}
    staged = TK.sgm_staged_hwd

    def spy(cost_hwd, p1, p2):
        seen["cost"] = cost_hwd.clone()
        seen["agg"] = staged(cost_hwd, p1, p2)
        return seen["agg"]

    args = (_t(grays[2]), _t(grays[1]), _t(poses[2]), _t(poses[1]), _t(intr), 6.0, 16.0)
    d0, _, v0 = TR.rectified_pair_depth(*args, n_levels=32, max_cost=0.35, use_sgm=True)
    monkeypatch.setattr(TR, "STAGED_SGM_MIN_PIXELS", H * W)
    monkeypatch.setattr(TK, "sgm_staged_hwd", spy)
    d1, _, v1 = TR.rectified_pair_depth(*args, n_levels=32, max_cost=0.35, use_sgm=True)
    want = sgm_staged_hwd(jnp.asarray(seen["cost"].numpy()), 0.03, 0.3, interpret=True)
    np.testing.assert_allclose(seen["agg"].numpy(), np.asarray(want)[:, :, :32], atol=1e-5)
    med, agree = _agree(d1.numpy(), v1.numpy(), d0.numpy(), v0.numpy())
    assert med <= 1e-3 and agree >= 0.95, (med, agree)


def test_consensus_fuse():
    rng = np.random.default_rng(3)
    n, h, w = 4, 20, 30
    base = rng.uniform(5, 9, (h, w))
    depths = (base[None] * (1 + rng.choice([0.0, 0.005, 0.1], size=(n, h, w)))).astype(np.float32)
    costs = rng.uniform(0, 0.5, (n, h, w)).astype(np.float32)
    valids = rng.random((n, h, w)) > 0.3
    out_t = TR.consensus_fuse(_t(depths), _t(costs), _t(valids), max_cost=0.35)
    out_j = JR.consensus_fuse(jnp.asarray(depths), jnp.asarray(costs), jnp.asarray(valids),
                              max_cost=0.35)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), rtol=1e-6)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))


def test_rect_host_helpers(scene):
    _, _, poses, _ = scene
    for r in range(5):
        nb = [i for i in range(5) if i != r]
        np.testing.assert_array_equal(TR.rect_geometry_ok(poses[r], poses[nb]),
                                      JR.rect_geometry_ok(poses[r], poses[nb]))
        for f, zmin, width in ((140.0, 6.0, 160), (3840.0, 5.0, 3200), (3840.0, 0.01, 3200)):
            assert TR.derive_max_disp(poses[r], poses[nb], f, zmin, width) == \
                JR.derive_max_disp(poses[r], poses[nb], f, zmin, width)


def test_unproject_and_project(scene):
    _, gt, poses, intr = scene
    pose = poses[3] + np.array([0.02, -0.01, 0.03, 0, 0, 0], np.float32)
    pw_t, n_t = TF.unproject_depth(_t(gt[3]), None, _t(pose), _t(intr))
    pw_j, n_j = JF.unproject_depth(jnp.asarray(gt[3]), jnp.asarray(gt[3] > 0),
                                   jnp.asarray(pose), jnp.asarray(intr))
    np.testing.assert_allclose(pw_t.numpy(), np.asarray(pw_j), atol=1e-5)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-5)
    pts = pw_t.reshape(-1, 3)[::37]
    for a, b in zip(TF.project_points_depth(pts, _t(poses[1]), _t(intr)),
                    JF.project_points_depth(jnp.asarray(pts.numpy()), jnp.asarray(poses[1]),
                                            jnp.asarray(intr))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-4)


def test_plain_k2a_matches_scan_and_pallas(rng):
    """The plain version of K2a along both axes against the JAX
    package's lax.scan recurrence and its Pallas kernel (interpret mode),
    at the (13, 21, 37) shapes of tests/test_mvs.py."""
    h, w, d = 13, 21, 37
    v = rng.random((h, w, d)).astype(np.float32)
    vj = jnp.asarray(v)
    p1, p2 = 0.05, 0.4
    lr = jnp.swapaxes(JS._scan_dir(jnp.swapaxes(vj, 0, 1), p1, p2), 0, 1)
    rl = jnp.swapaxes(JS._scan_dir(jnp.swapaxes(vj, 0, 1)[::-1], p1, p2)[::-1], 0, 1)
    tb = JS._scan_dir(vj, p1, p2)
    bt = JS._scan_dir(vj[::-1], p1, p2)[::-1]
    horiz = TK.sgm_bidir(_t(v), p1, p2, axis=1).numpy()  # CPU tensor: the plain version
    vert = TK.sgm_bidir(_t(v), p1, p2, axis=0).numpy()
    np.testing.assert_allclose(horiz, np.asarray(lr + rl), atol=1e-6)
    np.testing.assert_allclose(vert, np.asarray(tb + bt), atol=1e-6)
    np.testing.assert_allclose(horiz, np.asarray(sgm_bidir_pallas(vj, p1, p2, interpret=True)),
                               atol=1e-6)
    pal_v = jnp.swapaxes(sgm_bidir_pallas(jnp.swapaxes(vj, 0, 1), p1, p2, interpret=True), 0, 1)
    np.testing.assert_allclose(vert, np.asarray(pal_v), atol=1e-6)
    # the dispatcher on (D, H, W): TPU summation order vs the JAX CPU order
    agg = TS.sgm_aggregate(_t(np.moveaxis(v, -1, 0).copy()), p1, p2).numpy()
    want = JS.sgm_aggregate(jnp.moveaxis(vj, -1, 0), p1, p2)
    np.testing.assert_allclose(agg, np.asarray(want), atol=1e-6)


def test_plain_k2b_matches_staged_pallas(rng):
    """The plain version of K2b, through the staged 4-path sum, against
    the JAX package's staged Pallas kernel (interpret mode) on costs of a
    bf16-exact grid with power-of-two penalties."""
    h, w, d = 13, 21, 37
    v = (rng.integers(0, 128, size=(h, w, d)) / 64.0).astype(np.float32)
    p1, p2 = 0.0625, 0.5
    out = TK.sgm_staged_hwd(_t(v), p1, p2).numpy()
    want = np.asarray(sgm_staged_hwd(jnp.asarray(v), p1, p2, interpret=True))[:, :, :d]
    np.testing.assert_allclose(out, want, atol=1e-5)
    # one direction alone accumulates in place
    acc = torch.ones((h, w, d))
    res = TK.sgm_dir_acc(_t(v).bfloat16(), acc, p1, p2, axis=0, reverse=True)
    assert res is acc
    tb_rev = np.asarray(JS._scan_dir(jnp.asarray(v)[::-1], p1, p2)[::-1])
    np.testing.assert_allclose(acc.numpy(), 1.0 + tb_rev, atol=1e-5)


def test_mesh_texture_refine(scene):
    """Meshing and texturing (torch on the given device, here the CPU) and
    the photometric refinement (torch ZNCC scorer) against the JAX package
    on the scene's exact depth maps. Mesh vertices atol 1e-4 (f32
    back-projection, then cluster means), faces exact; texture coordinates
    and face views exact, atlas texels within 1 and >= 99.9% exact (the
    JAX package's bilinear blend is float64, numpy promoting float32 less
    an int32 index, the port's float32: a blend next to a half rounds to
    its neighbour); refinement: >= 99% of vertices move to the same place
    (a ZNCC near-tie between two offsets may resolve differently), all
    within 1e-4."""
    from sfm_mvs_pipeline_tpu.mvs import mesh as JM
    from sfm_mvs_pipeline_tpu.mvs import refine as JRF
    from sfm_mvs_pipeline_tpu.mvs import texture as JT
    from sfm_mvs_pipeline_tpu_torch.mvs import mesh as TM
    from sfm_mvs_pipeline_tpu_torch.mvs import refine as TRF
    from sfm_mvs_pipeline_tpu_torch.mvs import texture as TT

    grays, gt, poses, intr = scene
    valids = np.ones_like(gt, bool)
    valids[:, :5] = False
    rgbs = np.repeat((grays * 255).astype(np.uint8)[..., None], 3, axis=-1)
    mt = TM.mesh_from_depth_maps(gt, valids, poses, intr, rgbs, device="cpu")
    mj = JM.mesh_from_depth_maps(gt, valids, poses, intr, rgbs)
    np.testing.assert_array_equal(mt["faces"], mj["faces"])
    np.testing.assert_allclose(mt["vertices"], mj["vertices"], atol=1e-4)
    V, Fc = mj["vertices"], mj["faces"]
    tt = TT.build_texture_atlas(V, Fc, poses, intr, rgbs, device="cpu")
    tj = JT.build_texture_atlas(V, Fc, poses, intr, rgbs)
    for k in ("uv", "face_view"):
        np.testing.assert_array_equal(tt[k], tj[k])
    assert tt["atlas"].shape == tj["atlas"].shape and tt["atlas"].dtype == np.uint8
    diff = np.abs(tt["atlas"].astype(int) - tj["atlas"].astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())
    rt = TRF.refine_mesh_photometric(V, Fc, poses, intr, grays, device="cpu")
    rj = JRF.refine_mesh_photometric(V, Fc, poses, intr, grays)
    same = np.all(np.abs(rt - rj) <= 1e-4, axis=1)
    assert same.mean() >= 0.99, same.mean()


@pytest.mark.parametrize("faces", [np.zeros((0, 3), int), np.array([[0, 2, 1], [3, 4, 5]])],
                         ids=["no faces", "a face behind the views"])
def test_texture_atlas_edges_match_jax(scene, faces):
    """build_texture_atlas on "cpu" against the JAX package where a face
    has no view or there is no face: the same atlas (one block per face,
    at least one block, 128 where no view sees the face), coordinates and
    face views (-1 for the face behind every camera)."""
    from sfm_mvs_pipeline_tpu.mvs import texture as JT
    from sfm_mvs_pipeline_tpu_torch.mvs import texture as TT

    grays, _, poses, intr = scene
    rgbs = np.repeat((grays * 255).astype(np.uint8)[..., None], 3, axis=-1)
    V = np.array([[0, 0, 8.0], [0.5, 0, 8.0], [0, 0.5, 8.0],
                  [0, 0, -8.0], [0.5, 0, -8.0], [0, 0.5, -8.0]])
    tt = TT.build_texture_atlas(V, faces, poses, intr, rgbs, device="cpu")
    tj = JT.build_texture_atlas(V, faces, poses, intr, rgbs)
    for k in ("atlas", "uv", "face_view"):
        np.testing.assert_array_equal(tt[k], tj[k])
    assert tt["atlas"].shape == ((8, 16, 3) if len(faces) else (8, 8, 3))
    if len(faces):
        assert tt["face_view"][0] >= 0 and tt["face_view"][1] == -1
        assert (tt["atlas"][:, 8:] == 128).all() and (tt["atlas"][:, :8] != 128).any()
    else:
        assert (tt["atlas"] == 128).all()


@pytest.mark.parametrize("noise", [0.0, 0.02], ids=["exact", "noisy"])
def test_mesh_steps_match_jax(scene, noise):
    """mesh_from_depth_maps step by step against the JAX package on the same
    depth maps: faces after back-projection, cluster_vertices,
    remove_small_components, close_holes and smoothing all equal, on the
    scene's exact depth and on depth with PatchMatch-like noise (2% of
    depth, 10% of the pixels invalid), where clustering keeps more faces.
    The noisy case is the one that settles where a PatchMatch mesh's
    extra faces come from (tests/dense_counts.py has the CLI's counts)."""
    from sfm_mvs_pipeline_tpu.mvs import mesh as JM
    from sfm_mvs_pipeline_tpu_torch.mvs import mesh as TM
    from tests.dense_counts import _jax_mesh_steps_logged

    grays, gt, poses, intr = scene
    rng = np.random.default_rng(7)
    depth = (gt * (1 + noise * rng.standard_normal(gt.shape))).astype(np.float32)
    valids = rng.random(gt.shape) > (0.1 if noise else 0.0)
    logs = {"port": [], "jax": []}
    TM.mesh_from_depth_maps(depth, valids, poses, intr, device="cpu", log=logs["port"].append)
    with _jax_mesh_steps_logged(logs["jax"].append):
        JM.mesh_from_depth_maps(depth, valids, poses, intr, log=logs["jax"].append)
    steps = ["raw mesh", "clustered", "small components removed", "holes closed", "cleaned"]

    def faces(lines):
        return {k: next(int(m.group(1)) for ln in lines
                        if (m := re.search(re.escape(k) + r": \d+ verts, (\d+) faces", ln)))
                for k in steps}

    assert faces(logs["port"]) == faces(logs["jax"])


@pytest.mark.parametrize("stride", [1, 2])
def test_depth_map_to_mesh_matches_jax(scene, stride):
    """One view's triangulation, built in torch (here on the CPU), against
    the JAX package's numpy one on noisy depth with invalid pixels: faces
    and colours equal, the used vertices within the back-projection's f32
    atol (1e-5 on depths of ~8-12)."""
    from sfm_mvs_pipeline_tpu.mvs import mesh as JM
    from sfm_mvs_pipeline_tpu_torch.mvs import mesh as TM

    grays, gt, poses, intr = scene
    rng = np.random.default_rng(3)
    depth = (gt[1] * (1 + 0.02 * rng.standard_normal(gt[1].shape))).astype(np.float32)
    valid = rng.random(depth.shape) > 0.1
    rgb = rng.integers(0, 256, depth.shape + (3,)).astype(np.uint8)
    vt, ft, ct = TM.depth_map_to_mesh(depth, valid, poses[1], intr, rgb, stride=stride,
                                      device="cpu")
    vj, fj, cj = JM.depth_map_to_mesh(depth, valid, poses[1], intr, rgb, stride=stride)
    assert len(fj) > 1000
    np.testing.assert_array_equal(ft.numpy(), fj)
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_allclose(vt.numpy(), vj, atol=1e-5)


@pytest.mark.parametrize("cell", [0.02, 0.005])
def test_cluster_vertices_matches_jax(cell):
    """cluster_vertices in torch on the CPU against the JAX package's numpy
    one on float32 vertices with repeated and degenerate faces: every
    output equal, the float64 means too (both sum in input order here)."""
    from sfm_mvs_pipeline_tpu.mvs.mesh import cluster_vertices as j_cluster
    from sfm_mvs_pipeline_tpu_torch.mvs.mesh import cluster_vertices as t_cluster

    rng = np.random.default_rng(9)
    n = 60_000
    verts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    faces = rng.integers(0, n, (120_000, 3))
    faces[::4] = faces[1::4][: len(faces[::4])]
    faces[::9, 2] = faces[::9, 0]
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    got = t_cluster(torch.from_numpy(verts), torch.from_numpy(faces), torch.from_numpy(cols), cell)
    want = j_cluster(verts, faces, cols, cell)
    assert len(want[1]) > 1000
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
