"""The one-process mesh on the card: two shards on card 0
("cuda:0,cuda:0") and, where four cards exist, one shard a card
("cuda:0,cuda:1,cuda:2,cuda:3"). Each case skips below the cards it needs.

Against a mesh of the first card alone on the same inputs: the matcher
(K1; K1x with exact=True) and the view-sharded depth maps (rect --sgm with
K2a, PatchMatch with K3) bit-equal, point-sharded BA (float64) within cost
rel 1e-9 and arrays 1e-7 with the same iterations, two BA runs
bit-identical; every card of the mesh launched each kernel. The wrappers
raise on inputs on two devices, and a card that does not exist raises.
This file imports no JAX, so on the card it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_mesh_gpu.py
"""

import numpy as np
import pytest
import torch

MESHES = ["cuda:0,cuda:0", "cuda:0,cuda:1,cuda:2,cuda:3"]


def _needs(devices: str) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    need = 1 + max(int(d.split(":")[1]) for d in devices.split(","))
    if torch.cuda.device_count() < need:
        pytest.skip(f"needs {need} cards")


def _depth_inputs(rng, V=8, H=48, W=64):  # V a multiple of the shards: each has views
    from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import make_depth_planes
    from sfm_mvs_pipeline_tpu_torch.parallel.mvs import fixed_neighbor_table

    grays = rng.random((V, H, W)).astype(np.float32)
    poses = np.zeros((V, 6), np.float32)
    poses[:, 3] = 0.1 * np.arange(V)
    intr = np.array([60.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    nbrs = {v: [u for u in range(V) if u != v][:3] for v in range(V)}
    nbr_idx, nbr_valid = fixed_neighbor_table(nbrs, list(range(V)), 3)
    planes = np.stack([make_depth_planes(2.0, 6.0, 16)] * V).astype(np.float32)
    return grays, poses, intr, nbr_idx, nbr_valid, planes


@pytest.mark.gpu
@pytest.mark.parametrize("devices", MESHES)
def test_mesh_paths_on_the_cards(devices):
    _needs(devices)
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import build
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2
    from sfm_mvs_pipeline_tpu_torch.parallel.ba import run_bundle_adjustment_sharded
    from sfm_mvs_pipeline_tpu_torch.parallel.matching import match_pairs_sharded
    from sfm_mvs_pipeline_tpu_torch.parallel.mvs import compute_depth_maps_sharded
    from sfm_mvs_pipeline_tpu_torch.sfm.ba import BAConfig

    cards = sorted({int(d.split(":")[1]) for d in devices.split(",")})
    rng = np.random.default_rng(0)
    S, F, D = 5, 300, 128
    d = rng.integers(0, 256, size=(S, F, D)).astype(np.float32)
    v = rng.random((S, F)) > 0.1
    pairs = np.array([(a, b) for a in range(S) for b in range(a + 1, S)], np.int32)
    for exact, kern in ((False, K.two_nn_batch_fused), (True, K.two_nn_exact_batch)):
        build.reset_launches(kern)
        got = match_pairs_sharded(d, v, pairs, with_distance=True, exact=exact, device=devices)
        assert all(kern.by_card.get(c, 0) > 0 for c in cards), kern.by_card
        ref = match_pairs_sharded(d, v, pairs, with_distance=True, exact=exact,
                                  device="cuda:0")
        assert all(a.device == torch.device("cuda", 0) and torch.equal(a, b)
                   for a, b in zip(got, ref))

    inputs = _depth_inputs(rng)
    for kw, kern in ((dict(method="rect", use_sgm=True), K2.sgm_bidir),
                     (dict(method="patchmatch", pm_iterations=2), K3.pm_score_rect)):
        build.reset_launches(kern)
        got = compute_depth_maps_sharded(*inputs, window_radius=2, device=devices, **kw)
        assert all(kern.by_card.get(c, 0) > 0 for c in cards), kern.by_card
        ref = compute_depth_maps_sharded(*inputs, window_radius=2, device="cuda:0", **kw)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)

    args = _ba_problem_np(rng)
    kw = dict(config=BAConfig(max_iterations=10), dtype=torch.float64)
    one = run_bundle_adjustment_sharded(*args, device="cuda:0", **kw)
    runs = [run_bundle_adjustment_sharded(*args, device=devices, **kw) for _ in range(2)]
    for k in ("points", "poses", "intrinsics"):
        np.testing.assert_array_equal(runs[0][k], runs[1][k])
        np.testing.assert_allclose(runs[0][k], one[k], atol=1e-7)
    assert runs[0]["cost"] == pytest.approx(one["cost"], rel=1e-9)
    assert runs[0]["iterations"] == one["iterations"]


def _ba_problem_np(rng, n_shots=6, n_pts=600, f=400.0):
    """A BA problem of n_shots cameras on an arc around n_pts points, 0.3 px
    of noise, the points moved off their optimum."""
    pts = rng.uniform(-2, 2, size=(n_pts, 3))
    pts[:, 2] += 8
    poses = np.zeros((n_shots, 6))
    obs_p, obs_s, obs_uv = [], [], []
    for s in range(n_shots):
        ang = (s - n_shots / 2) * 0.1
        poses[s] = [0, ang, 0, -np.sin(ang), 0, 8 - 8 * np.cos(ang)]
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        pc = pts @ R.T + poses[s][3:]
        uv = pc[:, :2] / pc[:, 2:3] * f + [160, 120] + rng.normal(size=(n_pts, 2)) * 0.3
        sel = rng.random(n_pts) < 0.8
        obs_p.append(np.nonzero(sel)[0])
        obs_s.append(np.full(sel.sum(), s))
        obs_uv.append(uv[sel])
    imask = np.zeros((1, 7))
    imask[0, 0] = 1.0
    op = np.concatenate(obs_p).astype(np.int32)
    return (pts + rng.normal(size=pts.shape) * 0.02, poses,
            np.array([[f, 160, 120, 0, 0, 0, 0]]), np.zeros(n_shots, np.int32), op,
            np.concatenate(obs_s).astype(np.int32), np.concatenate(obs_uv), np.ones(len(op)),
            imask)


@pytest.mark.gpu
def test_kernels_raise_on_inputs_on_two_devices():
    _needs("cuda:0")
    from sfm_mvs_pipeline_tpu_torch import resolve_devices
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    other = "cuda:1" if torch.cuda.device_count() > 1 else "cpu"
    d = torch.zeros((2, 128, 128), device="cuda:0")
    v = torch.ones((2, 128), dtype=torch.bool, device=other)
    p = torch.zeros((1, 2), dtype=torch.int32, device="cuda:0")
    for fn in (K.two_nn_batch_fused, K.two_nn_exact_batch):
        with pytest.raises(ValueError, match="valid is on"):
            fn(d, v, p)
    cost = torch.zeros((8, 8, 16), dtype=torch.bfloat16, device="cuda:0")
    with pytest.raises(ValueError, match="accumulator|does not match the cost"):
        K2.sgm_dir_acc(cost, torch.zeros((8, 8, 16), device=other), 0.03, 0.3, 0, False)
    c = torch.zeros((1, 8, 8), device="cuda:0")
    maps = [torch.zeros((8, 8), device="cuda:0") for _ in range(4)]
    maps[1] = maps[1].to(other)
    with pytest.raises(ValueError, match="K3 takes"):
        K3.pm_score_rect(c, maps[0], maps[1], torch.ones((8, 8), dtype=torch.bool,
                                                          device="cuda:0"), maps[2], maps[3], 4)
    with pytest.raises(RuntimeError, match="no card"):
        resolve_devices(f"cuda:{torch.cuda.device_count()}")
