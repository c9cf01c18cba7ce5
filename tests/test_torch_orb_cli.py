"""The port's ORB path end to end: the CLI on the bundled insel images at
their stored size with -Pfeature-detector=ORB -Pfeature-limit=0
-Pdevice=cpu (ORB at capacity 4,096, its packed bits expanded to +-1 and
matched by K1's plain version at D = 256).

Bounds: 3/3 views and median reprojection < 1 px, as the JAX package's CLI
gets on the same command (3/3 views, 1,610 sparse points, 4,035 / 3,917 /
3,948 features); the port's feature counts equal the JAX package's to 1%
and its sparse point count lies within 25% of 1,610 (RANSAC draws differ
between the packages). Kept in its own file: it is the longest ORB case.
"""

import os

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.cli.app import main as t_main
from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene
from sfm_mvs_pipeline_tpu_torch.utils.stats import reprojection_errors

torch.set_num_threads(2)

INSEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_data", "insel")
JAX_FEATURES = (4035, 3917, 3948)
JAX_POINTS = 1610


def test_insel_orb_cli_on_cpu(tmp_path):
    out = tmp_path / "out"
    assert t_main(["-Prun=photogrammetrie", f"-Pimage={INSEL}", f"-Pout={out}", "-Ploglevel=4",
                   "-Pdevice=cpu", "-Pfeature-detector=ORB", "-Pfeature-limit=0"]) == 0
    scene = load_scene(str(out / "scene.npz"))
    assert scene.descriptors.shape[1:] == (4096, 256)
    assert np.array_equal(np.abs(scene.descriptors), np.ones_like(scene.descriptors))
    feats = scene.feat_valid.sum(axis=1)
    np.testing.assert_allclose(feats, JAX_FEATURES, rtol=0.01)
    assert int(scene.recovered.sum()) == 3
    assert np.median(reprojection_errors(scene)) < 1.0
    n_pts = int(scene.point_valid.sum())
    assert abs(n_pts - JAX_POINTS) <= 0.25 * JAX_POINTS, n_pts
