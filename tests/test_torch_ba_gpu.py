"""Bundle adjustment's CUDA graph route on the card (sfm/ba.py::lm_solve):
each LM iteration replayed from one graph captured at the first, held bit
for bit to the eager loop of the same step function on the same card.

Both layouts (the dense grid; the track table, forced by a point observed
twice in one shot), a solve that stops at its first iteration and one that
runs to max_iterations, and one solve captured and replayed under
torch.profiler with CUDA activity, as the benchmark's traced runs do. The
eager loop is taken by stubbing the engage rule. This file imports no JAX,
so on the card it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_ba_gpu.py
"""

import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu_torch.sfm import ba as B
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _problem(layout: str, n_shots=12, n_pts=3000, seed=0):
    """A ring of cameras around a point cloud, observations with 0.3 px of
    noise, points and poses perturbed; "track" adds a second observation
    of one point in one shot."""
    rng = np.random.default_rng(seed)
    f, w, h = 1680.0, 1920.0, 1080.0
    intr = np.array([[f, w / 2, h / 2, 0, 0, 0, 0]])
    pts = rng.uniform(-2, 2, (n_pts, 3)) + [0, 0, 10.0]
    ang = (np.arange(n_shots) - n_shots / 2) * 0.06
    poses = np.zeros((n_shots, 6))
    poses[:, 1] = ang  # a rotation about y
    centers = np.stack([10 * np.sin(ang), 0.05 * np.arange(n_shots), 10 - 10 * np.cos(ang)], 1)
    R = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
                  for a in ang])
    poses[:, 3:] = -np.einsum("sij,sj->si", R, centers)
    cam = np.einsum("sij,pj->spi", R, pts) + poses[:, None, 3:]
    uv = cam[..., :2] / cam[..., 2:] * f + [w / 2, h / 2]
    obs_point = np.tile(np.arange(n_pts), n_shots)
    obs_shot = np.repeat(np.arange(n_shots), n_pts)
    obs_uv = uv.reshape(-1, 2) + rng.normal(size=(n_pts * n_shots, 2)) * 0.3
    obs_w = np.ones(len(obs_uv))
    if layout == "track":
        obs_point = np.concatenate([obs_point, [3]])
        obs_shot = np.concatenate([obs_shot, [1]])
        obs_uv = np.concatenate([obs_uv, obs_uv[n_pts + 3: n_pts + 4] + 0.5])
        obs_w = np.concatenate([obs_w, [1.0]])
    pts_n = pts + rng.normal(size=pts.shape) * 0.05
    poses_n = poses.copy()
    poses_n[1:] += rng.normal(size=(n_shots - 1, 6)) * 0.01
    mask = np.zeros((1, 7))
    mask[:, [0, 3, 4]] = 1.0
    pose_free = np.ones(n_shots)
    pose_free[0] = 0.0
    cam_of_shot = np.zeros(n_shots, np.int32)
    return ((pts_n, poses_n, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w),
            dict(intr_mask=mask, pose_free=pose_free))


# "first": every accepted step counts as converged, so the solve stops at
# its first iteration; "max": no step does, so it runs to max_iterations
STOPS = {"first": (B.BAConfig(function_tolerance=1.0), 1),
         "max": (B.BAConfig(max_iterations=12, function_tolerance=0.0), 12)}


def _solve(args, kw, cfg, dev, graphed, monkeypatch):
    """run_bundle_adjustment on `dev`, on the graph route or the eager one,
    with its "lm iterations" and "ba graph iterations" counters."""
    monkeypatch.setattr(B, "_graph_engages", lambda *a: graphed)
    stage_timer.enable()
    try:
        out = B.run_bundle_adjustment(*args, **kw, config=cfg, device=dev)
    finally:
        stage_timer.enable(False)
    counted = stage_timer.counters()
    return out, counted.get("lm iterations"), counted.get("ba graph iterations")


def _assert_same_bits(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.gpu
@pytest.mark.parametrize("stop", sorted(STOPS))
@pytest.mark.parametrize("layout", ["dense", "track"])
def test_graph_route_equals_the_eager_loop(layout, stop, monkeypatch):
    dev = _card()
    args, kw = _problem(layout)
    cfg, iters = STOPS[stop]
    eager, n_eager, g_eager = _solve(args, kw, cfg, dev, False, monkeypatch)
    graph, n_graph, g_graph = _solve(args, kw, cfg, dev, True, monkeypatch)
    assert eager["table_kind"] == layout
    assert eager["iterations"] == iters
    assert (n_eager, g_eager) == (iters, None)
    assert (n_graph, g_graph) == (iters, iters)
    _assert_same_bits(graph, eager)
    if stop == "max":
        n_obs = len(args[-1])
        assert np.sqrt(2 * graph["cost"] / n_obs) < 0.5  # 0.3 px noise, recovered


@pytest.mark.gpu
def test_graph_route_under_the_profiler(monkeypatch):
    """Captured and replayed while torch.profiler records CUDA activity:
    the same bits, and the replays' kernels in the trace."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    args, kw = _problem("dense", seed=1)
    cfg, iters = STOPS["max"]
    eager, _, _ = _solve(args, kw, cfg, dev, False, monkeypatch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph, n_graph, g_graph = _solve(args, kw, cfg, dev, True, monkeypatch)
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0]
    assert (n_graph, g_graph) == (iters, iters)
    _assert_same_bits(graph, eager)
    assert len(kernels) > 100 * iters  # each replay's ~600 kernels are traced


@pytest.mark.gpu
def test_graphs_release_their_memory(monkeypatch):
    """Each solve on the graph route releases its graph and the graph's
    pool: solves one after another leave the card's reserved memory as
    the first left it."""
    dev = _card()
    args, kw = _problem("dense", seed=2)
    cfg, _ = STOPS["max"]
    reserved = []
    for _ in range(4):
        _solve(args, kw, cfg, dev, True, monkeypatch)
        reserved.append(torch.cuda.memory_reserved(dev))
    assert reserved[-1] == reserved[1], reserved
