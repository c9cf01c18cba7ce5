"""The port's whole sparse slice against the JAX package, through both CLIs.

Both CLIs run on the bundled insel images at 240x135 with
-Pfeature-limit=512 (as tests/test_insel_e2e.py does). RANSAC draws differ
between the packages (torch.Generator vs jax.random), so the runs are
compared as outcomes: both recover 3/3 views; after a sim(3) alignment the
camera centres differ by at most 1% of the trajectory extent; the port's
median reprojection is under 1 px; its sparse point count is within 15%
of the JAX package's. The port alone also runs the 8-view synthetic
ground-truth scene of tests/test_synthetic_gt.py with that test's bounds.
The port's CLI runs here on the CPU in float32, its working type on the card.
"""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu.cli.app import main as j_main
from sfm_mvs_pipeline_tpu.utils.checkpoint import load_scene as j_load
from sfm_mvs_pipeline_tpu_torch.cli.app import main as t_main
from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np
from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene as t_load
from sfm_mvs_pipeline_tpu_torch.utils.metrics import trajectory_compare
from sfm_mvs_pipeline_tpu_torch.utils.stats import reprojection_errors

torch.set_num_threads(2)

INSEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_data", "insel")


def _centers(scene):
    rec = np.nonzero(scene.recovered)[0]
    R = aa_to_rotmat_np(scene.poses[rec, :3])
    return rec, -np.einsum("sji,sj->si", R, scene.poses[rec, 3:]), R


def test_insel_slice_port_vs_jax(tmp_path):
    data = tmp_path / "insel_small"
    data.mkdir()
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        cv2.imwrite(str(data / name), cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA))
    args = [f"-Pimage={data}", "-Pfeature-limit=512", "-Ploglevel=4", "--colored", "--stats"]
    assert t_main(["-Prun=photogrammetrie", f"-Pout={tmp_path / 'out_t'}", "-Pdevice=cpu",
                   *args]) == 0
    assert j_main(["-Prun=photogrammetrie", f"-Pout={tmp_path / 'out_j'}", *args]) == 0
    for name in ("pointcloud_sparse.ply", "cameras_recovered.ply", "scene.npz",
                 "reprojectionerror.stat.csv"):
        assert (tmp_path / "out_t" / name).exists(), name

    st = t_load(str(tmp_path / "out_t" / "scene.npz"))
    sj = j_load(str(tmp_path / "out_j" / "scene.npz"))
    # the JAX run took its single-device branches (incremental.py:233, :311):
    # 3 pairs < one per device, and fewer live observations than the
    # 2048-per-device threshold of the sharded BA
    n_dev = len(jax.devices())
    assert 3 < n_dev and int((sj.obs_w > 0).sum()) < 2048 * n_dev

    assert int(st.recovered.sum()) == 3 and int(sj.recovered.sum()) == 3
    rec_t, C_t, R_t = _centers(st)
    rec_j, C_j, R_j = _centers(sj)
    cmp = trajectory_compare(C_t, R_t, C_j, R_j)
    extent = np.max(np.linalg.norm(C_j - C_j.mean(0), axis=1)) * 2
    assert cmp["ate_rmse"] <= 0.01 * extent, (cmp, extent)
    assert np.median(reprojection_errors(st)) < 1.0
    n_t, n_j = int(st.point_valid.sum()), int(sj.point_valid.sum())
    assert abs(n_t - n_j) <= 0.15 * n_j, (n_t, n_j)
    assert st.colors[st.point_valid][:, :3].max() > 30

    # scene.npz is one format: each package reads the other's checkpoint
    x = j_load(str(tmp_path / "out_t" / "scene.npz"))
    y = t_load(str(tmp_path / "out_j" / "scene.npz"))
    np.testing.assert_array_equal(x.poses, st.poses)
    np.testing.assert_array_equal(y.points, sj.points)
    assert y.camera_model == sj.camera_model and x.image_size == st.image_size


@pytest.mark.parametrize("planar", [False, True], ids=["two-plane", "planar"])
def test_synthetic_ground_truth_port(tmp_path, planar):
    """The 8-view renders of tests/test_synthetic_gt.py and, planar=True,
    of tests/test_planar_scene.py (the 8-point degeneracy the E-vs-H
    selection and the planar PnP family exist for), with their bounds."""
    from sfm_mvs_pipeline_tpu_torch.utils.synth import render_views

    data = tmp_path / "views"
    _, gt_R, gt_C = render_views(data, 8, 240, 320, 280.0, planar=planar)
    out = tmp_path / "out"
    rc = t_main(["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out}", "-Pdevice=cpu",
                 "-Pfeature-limit=800", "-Pfeature-sequence=3", "-Ploglevel=4"])
    assert rc == 0
    scene = t_load(str(out / "scene.npz"))
    rec, C, R = _centers(scene)
    assert len(rec) >= 7, f"only {len(rec)}/8 views recovered"
    cmp = trajectory_compare(C, R, gt_C[rec], gt_R[rec])
    extent = np.linalg.norm(gt_C[rec][-1] - gt_C[rec][0])
    assert cmp["ate_rmse"] / extent < 0.02, cmp
    assert cmp["max_rel_rot_deg"] < (1.5 if planar else 1.0)
    assert np.median(reprojection_errors(scene)) < 1.0


def test_unported_flags_exit_nonzero(tmp_path, capsys):
    """The flags that earlier slices refused (ORB, FLANN, -Pprofile=, and
    -Prun=pcl-stats) now run on -Pdevice=cpu: rc 0, no "not yet ported"
    message, a Chrome trace in the profile dir and the three pcl-stats
    outputs. Unknown values still exit non-zero."""
    out, prof = tmp_path / "o", tmp_path / "p"
    base = ["-Prun=photogrammetrie", f"-Pimage={INSEL}", f"-Pout={out}", "-Ploglevel=2",
            "-Pdevice=cpu", "-Pfeature-limit=512"]
    assert t_main(base + ["-Pfeature-detector=orb", "-Pfeature-matcher=flann",
                          f"-Pprofile={prof}"]) == 0
    assert "not yet ported" not in capsys.readouterr().out
    assert (prof / "trace.json").stat().st_size > 0
    cloud = out / "pointcloud_sparse"
    assert t_main(["-Prun=pcl-stats", f"-Pinput={cloud}.ply", "-Ploglevel=4"]) == 0
    for ext in ("stats.csv", "neighbors.csv", "quality.ply"):
        assert os.path.getsize(f"{cloud}.{ext}") > 0
    assert "not yet ported" not in capsys.readouterr().out
    assert t_main(base + ["-Pfeature-detector=surf"]) != 0
    assert t_main([a for a in base if a != "-Pdevice=cpu"] + ["-Pdevice=tpu"]) != 0
