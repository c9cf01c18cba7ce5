"""Parity of the port's bundle adjustment (sfm/ba.py) with the JAX package's.

Both start from one perturbed scene state at float64. Tolerances: final
cost to rel 1e-9, the same iteration count, poses and points within
atol 1e-7 — the same LM steps in float64 differ only by summation order
(~1e-15 relative per step).
"""

import cv2
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu.sfm.ba import BAConfig as JConfig
from sfm_mvs_pipeline_tpu.sfm.ba import build_track_table as j_track_table
from sfm_mvs_pipeline_tpu.sfm.ba import run_bundle_adjustment as j_ba
from sfm_mvs_pipeline_tpu_torch.sfm.ba import BAConfig as TConfig
from sfm_mvs_pipeline_tpu_torch.sfm.ba import build_track_table as t_track_table
from sfm_mvs_pipeline_tpu_torch.sfm.ba import run_bundle_adjustment as t_ba

torch.set_num_threads(2)


def _problem(synthetic_scene, rng, n_cams_intr=1, duplicate=False, freeze_first=False):
    s = synthetic_scene
    n_shots, n_pts = len(s["poses"]), len(s["points"])
    poses = np.stack([np.concatenate([cv2.Rodrigues(R)[0][:, 0], t]) for R, t in s["poses"]])
    obs_point = np.tile(np.arange(n_pts), n_shots)
    obs_shot = np.repeat(np.arange(n_shots), n_pts)
    obs_uv = np.concatenate(s["obs"]) + rng.normal(size=(n_pts * n_shots, 2)) * 0.3
    obs_w = np.ones(len(obs_uv))
    if duplicate:
        # a point observed twice in one shot (the PnP-registration defect):
        # forces the track layout on both sides
        obs_point = np.concatenate([obs_point, [3]])
        obs_shot = np.concatenate([obs_shot, [1]])
        obs_uv = np.concatenate([obs_uv, obs_uv[n_pts + 3 : n_pts + 4] + 0.5])
        obs_w = np.concatenate([obs_w, [1.0]])
    pts = s["points"] + rng.normal(size=(n_pts, 3)) * 0.05
    poses_n = poses.copy()
    poses_n[1:] += rng.normal(size=(n_shots - 1, 6)) * 0.01
    intr = np.repeat(s["intr"][None], n_cams_intr, axis=0)
    cam_of_shot = (np.arange(n_shots) % n_cams_intr).astype(np.int32)
    model = (0, 3, 4) if n_cams_intr == 1 else (0, 1, 2, 3, 4, 5, 6)
    mask = np.zeros((n_cams_intr, 7))
    mask[:, list(model)] = 1.0
    pose_free = np.ones(n_shots)
    if freeze_first:
        pose_free[0] = 0.0
    return (pts, poses_n, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w), mask, pose_free


@pytest.mark.parametrize(
    "case",
    [
        dict(),
        dict(duplicate=True),
        dict(n_cams_intr=2, freeze_first=True),
        dict(duplicate=True, freeze_first=True),
    ],
    ids=["dense", "track", "dense-2cams-frozen", "track-frozen"],
)
def test_ba_parity(synthetic_scene, rng, case):
    args, mask, pose_free = _problem(synthetic_scene, rng, **case)
    oj = j_ba(*args, intr_mask=mask, pose_free=pose_free, config=JConfig(max_iterations=30))
    ot = t_ba(*args, intr_mask=mask, pose_free=pose_free, config=TConfig(max_iterations=30),
              dtype=torch.float64, device="cpu")
    assert ot["table_kind"] == ("track" if case.get("duplicate") else "dense")
    assert ot["cost"] == pytest.approx(oj["cost"], rel=1e-9)
    assert ot["iterations"] == oj["iterations"]
    assert ot["converged"] == oj["converged"]
    np.testing.assert_allclose(ot["poses"], oj["poses"], atol=1e-7)
    np.testing.assert_allclose(ot["points"], oj["points"], atol=1e-7)
    np.testing.assert_allclose(ot["intrinsics"], oj["intrinsics"], atol=1e-7)
    n_obs = int((args[-1] > 0).sum())
    assert np.sqrt(2 * ot["cost"] / n_obs) < 0.5  # 0.3 px noise, recovered


def test_ba_host_solver_and_float32(synthetic_scene, rng):
    """The float64 host solver reaches the device solver's optimum; the
    float32 device run (the card's working type) converges to the same cost
    within f32 resolution (rel 1e-4)."""
    args, mask, pose_free = _problem(synthetic_scene, rng)
    dev = t_ba(*args, intr_mask=mask, config=TConfig(max_iterations=30), dtype=torch.float64, device="cpu")
    host = t_ba(*args, intr_mask=mask, config=TConfig(max_iterations=30, solver="host"),
                dtype=torch.float64, device="cpu")
    f32 = t_ba(*args, intr_mask=mask, config=TConfig(max_iterations=30), dtype=torch.float32, device="cpu")
    assert host["cost"] == pytest.approx(dev["cost"], rel=1e-9)
    assert f32["cost"] == pytest.approx(dev["cost"], rel=1e-4)
    assert f32["points"].dtype == np.float64  # outputs keep the input dtypes


def test_track_table_parity():
    obs_point = np.array([0, 0, 1, 2, 2, 2, 4])
    obs_w = np.array([1, 1, 1, 1, 0, 1.0, 1])
    np.testing.assert_array_equal(t_track_table(obs_point, obs_w, 5), j_track_table(obs_point, obs_w, 5))


@pytest.mark.parametrize(
    "dev,reduce,solver,engages",
    [("cuda:0", None, "device", True), ("cuda", None, "device", True),
     ("cpu", None, "device", False), ("cuda:0", lambda x: x, "device", False),
     ("cuda:0", None, "host", False)],
    ids=["cuda", "cuda-unindexed", "cpu", "reduce", "host-solver"],
)
def test_ba_graph_engage_rule(dev, reduce, solver, engages):
    """The step replays as a CUDA graph on one CUDA card with the device
    solver; the CPU, the sharded route's reduce and the host solver keep
    the eager loop."""
    from sfm_mvs_pipeline_tpu_torch.sfm.ba import _graph_engages

    assert _graph_engages(torch.device(dev), reduce, TConfig(solver=solver)) is engages


@pytest.mark.parametrize("solver", ["device", "host"])
def test_ba_graph_counter_on_the_cpu(synthetic_scene, rng, solver):
    """On the CPU every iteration runs eagerly: "lm iterations" counts
    them, "ba graph iterations" stays absent, and the inputs are left as
    given (the solver's state is a copy, updated in place)."""
    from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

    args, mask, pose_free = _problem(synthetic_scene, rng)
    before = [np.array(a, copy=True) for a in args]
    stage_timer.enable()
    try:
        out = t_ba(*args, intr_mask=mask, pose_free=pose_free,
                   config=TConfig(max_iterations=5, solver=solver), dtype=torch.float64,
                   device="cpu")
    finally:
        stage_timer.enable(False)
    counted = stage_timer.counters()
    assert counted["lm iterations"] == out["iterations"] > 0
    assert "ba graph iterations" not in counted
    for a, b in zip(args, before):
        np.testing.assert_array_equal(a, b)
