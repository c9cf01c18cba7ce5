"""The port's PatchMatch (mvs/patchmatch.py, kernel K3's plain version)
against the JAX package, on the CPU.

Inputs are made with numpy from a seed. The JAX package reaches its Pallas
kernel K3 in interpret mode, as tests/test_patchmatch_rect.py runs it. Both
sides compute in float32; random draws are JAX's, drawn with the key
splits of sfm_mvs_pipeline_tpu/mvs/patchmatch.py and handed to the port.
Tolerances, each with its reason:
  * checkerboard helpers: bit-equal (the same selects, gathers and adds in
    the same order); the rays atol 1e-6 (a 3x3 inverse and an einsum);
  * K3's plain version: atol 1e-5 against the Pallas kernel (XLA on the
    CPU rounds the window sums and the divisions differently, ~1.5e-6
    measured), atol 2e-4 against the numpy replica (the JAX test's bound);
  * PatchMatch with injected draws: the rectified images agree to ~1e-6
    and the window statistics come from cumulative sums that XLA and torch
    round differently (ZNCC cost differences up to 8e-4 where window
    variances are small), so an argmin or a `cbest < cost` can resolve
    differently and the two states then drift apart. Each test states the
    share of pixels whose depth agrees and its bound.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu.mvs import patchmatch as JPM
from sfm_mvs_pipeline_tpu.mvs.plane_sweep import _box_filter
from sfm_mvs_pipeline_tpu.ops.pallas.pm_kernel import pm_score_rect as j_score
from sfm_mvs_pipeline_tpu_torch.cli.app import main as t_main
from sfm_mvs_pipeline_tpu_torch.mvs import patchmatch as TPM
from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3
from sfm_mvs_pipeline_tpu_torch.utils.ply import read_ply
from tests.test_mvs import F, H, W, _render
from tests.test_patchmatch_rect import _np_score

torch.set_num_threads(2)

INSEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_data", "insel")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def plane_scene():
    """tests/test_mvs.py's two-plane scene, 120x160, cameras on a line."""
    rng = np.random.default_rng(5)
    centers = np.array([[-0.6, 0, 0], [-0.3, 0, 0], [0, 0, 0], [0.3, 0, 0], [0.6, 0, 0]])
    grays, gt = _render(rng, centers)
    poses = np.zeros((5, 6), np.float32)
    poses[:, 3:] = -centers
    intr = np.array([F, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    return grays, gt, poses, intr


def _jax_draws(key, iterations, shape0, shape):
    """The uniform draws of JAX's _pm_rect_pair / patchmatch_depth for
    `key`: u0, then (u_local, u_full) per iteration and parity."""
    key, k0 = jax.random.split(key)
    u0 = np.array(jax.random.uniform(k0, shape0, jnp.float32))
    halves = []
    for k in jax.random.split(key, iterations):
        for kk in jax.random.split(k):
            k1, k2 = jax.random.split(kk)
            halves.append((np.array(jax.random.uniform(k1, shape, jnp.float32)),
                           np.array(jax.random.uniform(k2, shape, jnp.float32))))
    return u0, halves


# ---------------------------------------------------------------------------
# helpers


@pytest.mark.parametrize("shape", [(6, 10), (3, 7, 12)])
def test_pack_unpack_shift(shape):
    rng = np.random.default_rng(0)
    x = rng.random(shape).astype(np.float32)
    for p in (0, 1):
        packed = TPM._pack(_t(x), p).numpy()
        np.testing.assert_array_equal(packed, np.asarray(JPM._pack(jnp.asarray(x), p)))
        full = x.reshape(-1, *shape[-2:])[0]
        vals = rng.random((shape[-2], shape[-1] // 2)).astype(np.float32)
        np.testing.assert_array_equal(
            TPM._unpack_update(_t(full), _t(vals), p).numpy(),
            np.asarray(JPM._unpack_update(jnp.asarray(full), jnp.asarray(vals), p)))
        # unpacking what was packed restores the plane
        np.testing.assert_array_equal(
            TPM._unpack_update(_t(full), TPM._pack(_t(full), p), p).numpy(), full)
    img = x.reshape(-1, *shape[-2:])[0]
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1), (2, -3)):
        np.testing.assert_array_equal(TPM._shift_edge(_t(img), dy, dx).numpy(),
                                      np.asarray(JPM._shift_edge(jnp.asarray(img), dy, dx)))


@pytest.mark.parametrize("r", [2, 3])
def test_parity_consts(plane_scene, r):
    grays, _, _, intr = plane_scene
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    rays_t = TPM._ref_rays(H, W, _t(K), torch.float32)
    rays_j = JPM._ref_rays(H, W, jnp.asarray(K), jnp.float32)
    np.testing.assert_allclose(rays_t.numpy(), np.asarray(rays_j), atol=1e-6)
    for p in (0, 1):
        ct = TPM._parity_consts(_t(grays[2]), rays_t, p, r)
        cj = JPM._parity_consts(jnp.asarray(grays[2]), jnp.asarray(rays_t.numpy()), p, r)
        assert len(ct["ref_sh"]) == (2 * r + 1) ** 2
        for a, b in zip(ct["ref_sh"], cj["ref_sh"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for k in ("rays", "r_mean", "r_var"):
            np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))


# ---------------------------------------------------------------------------
# K3's plain version


@pytest.mark.parametrize("r,h,w,maxd", [(2, 14, 72, 64), (3, 12, 150, 140)])
def test_pm_score_rect_plain(r, h, w, maxd):
    """Against the Pallas kernel (interpret mode) and the numpy replica:
    an invalid band and an invalid block in in_n, candidates over [0, maxd]
    with some exactly at maxd (taps left of the image read 0), and
    maxd = 140 > 128 (two 128-lane source blocks on the TPU)."""
    rng = np.random.default_rng(r * 100 + w)
    area = (2 * r + 1) ** 2
    ref = rng.random((h, w)).astype(np.float32)
    nbr = rng.random((h, w)).astype(np.float32)
    in_n = np.ones((h, w), bool)
    in_n[:, :5] = False
    in_n[4:7, 30:45] = False
    cands = (rng.random((3, h, w)) * maxd).astype(np.float32)
    cands[0, :, :20] = maxd
    cands[1, 2] = np.floor(cands[1, 2])  # integral disparities: frac = 0
    r_mean = (np.asarray(_box_filter(jnp.asarray(ref), r)) / area).astype(np.float32)
    r_sq = np.asarray(_box_filter(jnp.asarray(ref * ref), r)) / area
    r_var = np.maximum(r_sq - r_mean * r_mean, 1e-8).astype(np.float32)
    args = (cands, ref, nbr, in_n, r_mean, r_var)

    got = TPM.pm_score_rect_plain(*map(_t, args), maxd=maxd, window_radius=r)
    assert got.shape == (3, h, w) and got.dtype == torch.float32
    want_j = np.asarray(j_score(*map(jnp.asarray, args), maxd=maxd, window_radius=r,
                                interpret=True))
    np.testing.assert_allclose(got.numpy(), want_j, atol=1e-5)
    want_np = _np_score(cands.astype(np.float64), ref.astype(np.float64),
                        nbr.astype(np.float64), in_n, r_mean, r_var, maxd, r)
    np.testing.assert_allclose(got.numpy(), want_np, atol=2e-4)
    assert (got.numpy()[0, :, :20] == 1.0).all()  # centre taps left of the image
    # the wrapper takes the plain version for CPU tensors and counts nothing
    before = K3.pm_score_rect.launches
    via = K3.pm_score_rect(*map(_t, args), maxd=maxd, window_radius=r)
    assert torch.equal(via, got) and K3.pm_score_rect.launches == before


def test_pm_score_rect_plain_independent_of_maxd():
    """The plain version reads the neighbour directly: maxd changes the
    padding, not the result, and candidates beyond maxd read zeros like
    columns outside the image."""
    rng = np.random.default_rng(3)
    h, w, r = 9, 40, 3
    ref, nbr = rng.random((2, h, w)).astype(np.float32)
    in_n = rng.random((h, w)) > 0.1
    stats = [_t(rng.random((h, w)).astype(np.float32)) for _ in range(2)]
    cands = _t((rng.random((2, h, w)) * 30).astype(np.float32))
    a = TPM.pm_score_rect_plain(cands, _t(ref), _t(nbr), _t(in_n), *stats, maxd=30,
                                window_radius=r)
    b = TPM.pm_score_rect_plain(cands, _t(ref), _t(nbr), _t(in_n), *stats, maxd=300,
                                window_radius=r)
    assert torch.equal(a, b)
    far = TPM.pm_score_rect_plain(cands + 500.0, _t(ref), _t(nbr), _t(in_n), *stats, maxd=30,
                                  window_radius=r)
    assert (far == 1.0).all()


# ---------------------------------------------------------------------------
# rectified PatchMatch


def _shift_pair(rng, h=32, w=64, f=50.0, b=1.0, z=5.0):
    """tests/test_patchmatch_rect.py's laterally shifted texture pair:
    constant disparity f*b/z = 10 px, identity rotations."""
    tex = rng.random((h, w + 32)).astype(np.float32)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3.0
    di = int(f * b / z)
    ref = tex[:, 16:16 + w]
    nbr = tex[:, 16 + di:16 + di + w]
    pose_r = np.zeros(6, np.float32)
    pose_n = np.zeros(6, np.float32)
    pose_n[3] = -b
    intr = np.asarray([f, w / 2, h / 2, 0, 0, 0, 0], np.float32)
    return ref, nbr, pose_r, pose_n, intr, di


def test_pm_rect_pair_matches_jax_with_its_draws(rng):
    """_pm_rect_pair on a 32x64 pair with a small rotation (so the
    rectification resamples both images), fed JAX's draws, against JAX's
    _pm_rect_pair with K3 in interpret mode. Bounds: >= 97% of pixels agree
    on validity and, where both are valid, >= 95% have depths within 1e-4
    relative (measured: all pixels agree on validity and ~99.9% on depth;
    the rest are argmin near-ties after cumsum rounding)."""
    ref, nbr, pose_r, pose_n, intr, _ = _shift_pair(rng)
    pose_n[:3] = [0.004, -0.006, 0.003]
    it, r, md = 4, 2, 128
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, it, (32, 64), (32, 64))
    d_j, c_j, v_j = JPM._pm_rect_pair(
        *map(jnp.asarray, (ref, nbr, pose_r, pose_n, intr)), 2.0, 12.0, key, iterations=it,
        window_radius=r, max_cost=0.4, max_disp=md, interpret=True)
    d_t, c_t, v_t = TPM._pm_rect_pair(
        *map(_t, (ref, nbr, pose_r, pose_n, intr)), 2.0, 12.0, draws=draws, iterations=it,
        window_radius=r, max_cost=0.4, max_disp=md)
    d_j, v_j = np.asarray(d_j), np.asarray(v_j)
    d_t, v_t = d_t.numpy(), v_t.numpy()
    both = v_t & v_j
    assert both.mean() > 0.4, both.mean()
    agree_v = (v_t == v_j).mean()
    agree_d = (np.abs(d_t - d_j)[both] <= 1e-4 * np.abs(d_j[both])).mean()
    assert agree_v >= 0.97 and agree_d >= 0.95, (agree_v, agree_d)


def test_patchmatch_rect_depth_recovers_shift(rng):
    """tests/test_patchmatch_rect.py::test_pm_rect_pair_recovers_shift
    through the port (its own generator), under that test's limits."""
    ref, nbr, pose_r, pose_n, intr, di = _shift_pair(rng)
    z = 5.0
    gen = torch.Generator().manual_seed(0)
    dep, cost, valid = TPM.patchmatch_rect_depth(
        _t(ref), _t(nbr)[None], _t(pose_r), _t(pose_n)[None], _t(intr), 2.0, 12.0, gen,
        iterations=4, window_radius=2, max_disp=128)
    dep = dep.numpy()
    valid = valid.numpy().copy()
    valid[:, : di + 3] = False  # the left margin sees off-image sources
    assert valid.mean() > 0.4, f"valid frac {valid.mean()}"
    err = np.abs(dep[valid] - z) / z
    assert np.median(err) < 0.05, f"median depth err {np.median(err)}"


def test_patchmatch_rect_depth_draws_and_padded_slots(plane_scene):
    """patchmatch_rect_depth over four neighbour slots, the last a padded
    one, with JAX's per-neighbour draws, against the JAX package: the padded
    slot takes no part, and the fused depth agrees with JAX's on >= 95% of
    the pixels where both are valid (within 1e-4 relative; measured 97%);
    >= 97% agree on validity (measured 99.9%). Consensus needs two
    supporting neighbours, so about 60% of the pixels are valid. Then the
    ground truth: median relative error < 1%."""
    grays, gt, poses, intr = plane_scene
    nb = [1, 3, 0, 1]
    ok = np.array([True, True, True, False])
    it, r, md = 3, 2, 128
    key = jax.random.PRNGKey(2)
    draws = [_jax_draws(k, it, (H, W), (H, W)) for k in jax.random.split(key, len(nb))]
    d_j, _, v_j = JPM.patchmatch_rect_depth(
        jnp.asarray(grays[2]), jnp.asarray(grays[nb]), jnp.asarray(poses[2]),
        jnp.asarray(poses[nb]), jnp.asarray(intr), 6.0, 16.0, key, iterations=it,
        window_radius=r, max_cost=0.35, max_disp=md, nbr_valid=jnp.asarray(ok), interpret=True)
    d_t, _, v_t = TPM.patchmatch_rect_depth(
        _t(grays[2]), _t(grays[nb]), _t(poses[2]), _t(poses[nb]), _t(intr), 6.0, 16.0,
        iterations=it, window_radius=r, max_cost=0.35, max_disp=md, nbr_valid=ok, draws=draws)
    d_j, v_j, d_t, v_t = np.asarray(d_j), np.asarray(v_j), d_t.numpy(), v_t.numpy()
    both = v_t & v_j
    assert both.mean() > 0.5, both.mean()
    agree_v = (v_t == v_j).mean()
    agree_d = (np.abs(d_t - d_j)[both] <= 1e-4 * d_j[both]).mean()
    assert agree_v >= 0.97 and agree_d >= 0.95, (agree_v, agree_d)
    rel = np.abs(d_t - gt[2])[v_t] / gt[2][v_t]
    assert np.median(rel) < 0.01, np.median(rel)


# ---------------------------------------------------------------------------
# warp-based PatchMatch


def test_patchmatch_depth_matches_jax_with_its_draws(plane_scene):
    """The warp-based PatchMatch on the two-plane scene (4 neighbours, one
    padded slot, an odd width to exercise the edge-column pad), fed JAX's
    draws: >= 97% of pixels agree on validity and >= 95% of the jointly
    valid ones on depth within 1e-4 relative."""
    grays, _, poses, intr = plane_scene
    w = W - 1
    g = np.ascontiguousarray(grays[:, :, :w])
    nbrs = [0, 1, 3, 4]
    ok = np.array([True, True, True, False])
    it = 2
    key = jax.random.PRNGKey(4)
    draws = _jax_draws(key, it, (H, w + 1), (H, (w + 1) // 2))
    d_j, c_j, v_j = JPM.patchmatch_depth(
        jnp.asarray(g[2]), jnp.asarray(g[nbrs]), jnp.asarray(poses[2]), jnp.asarray(poses[nbrs]),
        jnp.asarray(intr), 6.0, 16.0, key, iterations=it, max_cost=0.35,
        nbr_valid=jnp.asarray(ok))
    d_t, c_t, v_t = TPM.patchmatch_depth(
        _t(g[2]), _t(g[nbrs]), _t(poses[2]), _t(poses[nbrs]), _t(intr), 6.0, 16.0,
        iterations=it, max_cost=0.35, nbr_valid=ok, draws=draws)
    assert d_t.shape == (H, w)
    d_j, v_j, d_t, v_t = np.asarray(d_j), np.asarray(v_j), d_t.numpy(), v_t.numpy()
    both = v_t & v_j
    assert both.mean() > 0.5, both.mean()
    agree_v = (v_t == v_j).mean()
    agree_d = (np.abs(d_t - d_j)[both] <= 1e-4 * d_j[both]).mean()
    assert agree_v >= 0.97 and agree_d >= 0.95, (agree_v, agree_d)


def test_patchmatch_depth_ground_truth(plane_scene):
    """tests/test_mvs.py::test_patchmatch_depth through the port (its own
    generator): valid > 70%, median relative error < 1%, > 500 distinct
    depths (continuous, not a plane ladder)."""
    grays, gt, poses, intr = plane_scene
    r, nbrs = 2, [0, 1, 3, 4]
    depth, cost, valid = TPM.patchmatch_depth(
        _t(grays[r]), _t(grays[nbrs]), _t(poses[r]), _t(poses[nbrs]), _t(intr), 6.0, 16.0,
        torch.Generator().manual_seed(0), iterations=6, max_cost=0.35)
    depth, valid = depth.numpy(), valid.numpy()
    assert valid.mean() > 0.7, valid.mean()
    rel = np.abs(depth - gt[r]) / gt[r]
    assert np.median(rel[valid]) < 0.01, np.median(rel[valid])
    assert len(np.unique(depth[valid])) > 500


def test_patchmatch_depth_seeded(plane_scene):
    """tests/test_mvs.py::test_patchmatch_seeded_matches_unseeded: a
    biased-but-close seed (+3%) does not hurt."""
    grays, gt, poses, intr = plane_scene
    r, nbrs = 2, [0, 1, 3, 4]
    seed = _t((gt[r] * 1.03).astype(np.float32))
    d1, _, v1 = TPM.patchmatch_depth(
        _t(grays[r]), _t(grays[nbrs]), _t(poses[r]), _t(poses[nbrs]), _t(intr), 6.0, 16.0,
        torch.Generator().manual_seed(1), init_depth=seed, iterations=5, max_cost=0.35)
    d1, v1 = d1.numpy(), v1.numpy()
    assert v1.mean() > 0.6
    assert np.median((np.abs(d1 - gt[r]) / gt[r])[v1]) < 0.01


def test_generator_streams():
    """split_generator gives reproducible, distinct streams; a run with a
    generator equals the run with the same numbers passed as draws."""
    a = [torch.rand(4, generator=g) for g in TPM.split_generator(torch.Generator().manual_seed(5), 3)]
    b = [torch.rand(4, generator=g) for g in TPM.split_generator(torch.Generator().manual_seed(5), 3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    rng = np.random.default_rng(1)
    ref, nbr, pose_r, pose_n, intr, _ = _shift_pair(rng, h=16, w=40)
    args = [*map(_t, (ref, nbr, pose_r, pose_n, intr)), 2.0, 12.0]
    gen = torch.Generator().manual_seed(9)
    u0 = torch.rand((16, 40), generator=torch.Generator().manual_seed(9))
    g2 = torch.Generator().manual_seed(9)
    g2.set_state(gen.get_state())
    u0 = torch.rand((16, 40), generator=g2)
    halves = [(torch.rand((16, 40), generator=g2), torch.rand((16, 40), generator=g2))
              for _ in range(4)]
    out_g = TPM._pm_rect_pair(*args, gen=gen, iterations=2, window_radius=2, max_disp=64)
    out_d = TPM._pm_rect_pair(*args, draws=(u0, halves), iterations=2, window_radius=2,
                              max_disp=64)
    for x, y in zip(out_g, out_d):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        TPM._pm_rect_pair(*args, draws=(u0, halves[:3]), iterations=2, max_disp=64)


# ---------------------------------------------------------------------------
# the slice: run_mvs and the CLI


@pytest.fixture(scope="module")
def insel_pm(tmp_path_factory):
    """The port's CLI, sparse + dense PatchMatch, on insel at 240x135."""
    tmp = tmp_path_factory.mktemp("pm_slice")
    data = tmp / "insel_small"
    data.mkdir()
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        cv2.imwrite(str(data / name), cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA))
    out = tmp / "out"
    rc = t_main(["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out}", "-Pfeature-limit=512",
                 "-Pdevice=cpu",
                 "-Ploglevel=4", "--dense", "-Pdense-method=patchmatch", "--mesh", "--colored",
                 "--artifacts"])
    assert rc == 0
    return tmp, out


def test_cli_patchmatch_outputs(insel_pm):
    """--dense -Pdense-method=patchmatch --mesh --colored writes a dense
    cloud and a textured mesh with points and faces."""
    _, out = insel_pm
    names = set(os.listdir(out))
    for name in ("pointcloud_dense.ply", "mesh_dense.ply", "mesh_dense.png", "scene.npz",
                 "depth_0000.npy", "depth_0001.npy", "depth_0002.npy"):
        assert name in names, name
    dense = read_ply(str(out / "pointcloud_dense.ply"))
    mesh = read_ply(str(out / "mesh_dense.ply"))
    assert len(dense["points"]) > 1000 and len(mesh["faces"]) > 1000
    assert np.isfinite(dense["points"]).all()


def test_run_mvs_patchmatch_vs_rect(insel_pm):
    """run_mvs(method="patchmatch") on the CLI's insel scene: 3/3 views
    densified by the rectified PatchMatch, held to the port's rect engine
    (a dense sweep over 96 levels) on the same scene, since insel has no
    ground truth and the JAX package on the CPU takes the warp-based
    branch. Bounds: where both are valid, >= 90% of the pixels have depths
    within 2% of each other (the sweep's 96 levels are ~1% apart in inverse
    depth), and the PatchMatch depth maps are at least half as dense."""
    from sfm_mvs_pipeline_tpu_torch.mvs import pipeline as TPIPE
    from sfm_mvs_pipeline_tpu_torch.utils import stage_timer
    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene

    tmp, out = insel_pm
    scene = load_scene(str(out / "scene.npz"))
    assert int(scene.recovered.sum()) == 3
    logs = []
    stage_timer.enable()
    try:
        res_pm = TPIPE.run_mvs(scene, str(tmp), TPIPE.MVSConfig(method="patchmatch"),
                               log=logs.append, device="cpu")
        stages = stage_timer.report()
    finally:
        stage_timer.enable(False)
    assert "(PatchMatch, 96 planes)" in logs[0], logs[0]
    assert sum("(rect-PM)" in m for m in logs) == 3, logs
    assert stages["patchmatch"][1] == 6 and stages["consensus"][1] == 3, stages
    res_rect = TPIPE.run_mvs(scene, str(tmp), TPIPE.MVSConfig(method="rect"), device="cpu")
    for i in range(3):
        d_p, v_p = res_pm["depth_maps"][i], res_pm["valids"][i]
        d_r, v_r = res_rect["depth_maps"][i], res_rect["valids"][i]
        np.testing.assert_array_equal(d_p, np.load(out / f"depth_{i:04d}.npy"))
        both = v_p & v_r
        close = (np.abs(d_p - d_r)[both] <= 0.02 * d_r[both]).mean()
        assert close >= 0.9, (i, close)
        assert v_p.sum() >= 0.5 * v_r.sum(), (i, v_p.sum(), v_r.sum())
    assert len(res_pm["dense"]["points"]) > 0


def test_patchmatch_view_degenerate_geometry_takes_warp_path(plane_scene, monkeypatch):
    """A view whose every neighbour fails the host's rectification geometry
    gate takes the warp-based PatchMatch, and K3 is not called. One
    neighbour lies on the ref's optical axis (a singular rectification: it
    must not seed), the other at sin 0.305 off it, between the engine's
    gate (0.3) and the host's (0.31), so the rectified seed is computed."""
    from sfm_mvs_pipeline_tpu_torch.mvs.pipeline import MVSConfig, _patchmatch_view

    grays, _, poses, intr = plane_scene
    fwd = np.zeros_like(poses)
    s = 0.305
    centres = {1: (0.0, 0.0, -0.3), 3: (0.3 * s, 0.0, 0.3 * np.sqrt(1 - s * s))}
    for v, c in centres.items():
        fwd[v, 3:] = -np.asarray(c, np.float32)

    def no_k3(*a, **k):
        raise AssertionError("K3 called on the warp-based path")

    monkeypatch.setattr(K3, "pm_score_rect", no_k3)
    cfg = MVSConfig(method="patchmatch", n_neighbors=2, window_radius=2)
    depth, cost, valid, tag = _patchmatch_view(
        cfg, 2, [1, 3], _t(grays), fwd, _t(fwd), _t(intr), float(F), 6.0, 16.0, W)
    assert tag == "" and depth.shape == (H, W)
    assert torch.isfinite(depth).all() and valid.dtype == torch.bool
