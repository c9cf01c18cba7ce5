"""PnP's Gauss-Newton polish (ops/pnp.py::_gn_polish) on the CPU: the
in-place step, called eagerly, held bit for bit to the loop it replaced
(a copy below, `pose = torch.where(...)` a step), and the counters a solve
adds. The graph route runs only on a card: tests/test_torch_pnp_gpu.py."""

import pytest
import torch

from sfm_mvs_pipeline_tpu_torch.models.cameras import project_points, undistort_points
from sfm_mvs_pipeline_tpu_torch.ops import pnp as P
from sfm_mvs_pipeline_tpu_torch.ops.ransac import sample_valid_indices, select_best, take
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

torch.set_num_threads(2)


def _problem(planar: bool, dtype, n=120, seed=0):
    """A map of n points seen by a distorted camera with 0.3 px of noise,
    its first sixth replaced by outliers, and the RANSAC draws."""
    g = torch.Generator().manual_seed(seed)
    f64 = {"generator": g, "dtype": torch.float64}
    X = torch.rand(n, 3, **f64) * 4 - 2 + torch.tensor([0, 0, 8.0])
    if planar:
        X[:, 2] = 8.0
    intr = torch.tensor([500.0, 320.0, 240.0, -0.05, 0.01, 0.0, 0.0], dtype=torch.float64)
    pose = torch.cat([torch.randn(3, **f64) * 0.1,
                      torch.tensor([0.3, -0.1, 0.5], dtype=torch.float64)])
    uv = project_points(pose, intr, X)[0] + torch.randn(n, 2, **f64) * 0.3
    uv[: n // 6] = torch.rand(n // 6, 2, **f64) * 640
    draws = (torch.rand(128, 6, generator=g, dtype=dtype),
             torch.rand(64, 4, generator=g, dtype=dtype))
    valid = torch.ones(n, dtype=torch.bool)
    return draws, X.to(dtype), uv.to(dtype), intr.to(dtype), valid


def _parent_solve(rng, X, uv, intr, valid, thresh_px, k_hyp=256, gn_iters=10):
    """solve_pnp_ransac as it was before the polish became an in-place step."""
    xy = undistort_points(intr, uv)
    k_dlt = k_hyp // 2
    k_pl = (k_hyp - k_dlt) // 2
    rng_d, rng_p = rng
    idx = sample_valid_indices(rng_d, valid, k_dlt, 6)
    poses_dlt = P._dlt_pnp(take(X, idx), take(xy, idx))
    idx4 = sample_valid_indices(rng_p, valid, k_pl, 4)
    poses_pl = P._planar_pnp(take(X, idx4), take(xy, idx4))
    poses = torch.cat([poses_dlt, poses_pl.reshape(-1, 6)])
    res = P._reproj_residuals_px(poses, intr, X, uv)
    pose, mask, _ = select_best(poses, res, valid, thresh_px)
    w = mask.to(X.dtype)

    def residual_vec(p):
        uv_hat, _ = project_points(p, intr, X)
        return ((uv_hat - uv) * w[:, None]).reshape(-1)

    eye = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(gn_iters):
        J = torch.func.jacfwd(residual_vec)(pose).to(X.dtype)
        r = residual_vec(pose)
        H = J.T @ J + 1e-6 * eye
        dp = torch.linalg.solve_ex(H, J.T @ r)[0]
        p_new = pose - dp
        better = torch.sum(residual_vec(p_new) ** 2) < torch.sum(r**2)
        pose = torch.where(better, p_new, pose)

    res_final = P._reproj_residuals_px(pose, intr, X, uv)
    mask = (res_final <= thresh_px) & valid & torch.isfinite(res_final)
    ratio = torch.sum(mask).to(X.dtype) / torch.clamp(torch.sum(valid), min=1).to(X.dtype)
    return pose, mask, ratio


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("gn_iters", [0, 1, 10])
@pytest.mark.parametrize("planar", [False, True])
def test_eager_polish_equals_the_parent_loop(planar, gn_iters, dtype):
    draws, X, uv, intr, valid = _problem(planar, dtype)
    want = _parent_solve(draws, X, uv, intr, valid, 4.0, gn_iters=gn_iters)
    got = P.solve_pnp_ransac(draws, X, uv, intr, valid, 4.0, gn_iters=gn_iters)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the outliers out, the rest in once polished
    assert float(got[2]) > (0.75 if gn_iters else 0.5)


@pytest.mark.parametrize("gn_iters", [0, 1, 10])
def test_counters_on_the_cpu(gn_iters):
    """One solve, gn_iters Gauss-Newton steps, none replayed from a graph."""
    draws, X, uv, intr, valid = _problem(False, torch.float64, seed=1)
    stage_timer.enable()
    try:
        P.solve_pnp_ransac(draws, X, uv, intr, valid, 4.0, gn_iters=gn_iters)
    finally:
        stage_timer.enable(False)
    counted = stage_timer.counters()
    assert counted["pnp solves"] == 1
    assert counted["pnp gn steps"] == gn_iters
    assert counted.get("pnp graph steps", 0) == 0


@pytest.mark.parametrize("device,gn_iters,engages", [
    ("cpu", 10, False),
    ("cuda:0", 10, True),
    ("cuda:0", 0, False),
])
def test_graph_engages_on_a_card_with_steps(device, gn_iters, engages):
    assert P._graph_engages(torch.device(device), gn_iters) is engages
