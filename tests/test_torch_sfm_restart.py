"""The port's restarted SfM starts (sfm/incremental.py).

A start whose bundle adjustment over three or more views leaves bogus
intrinsics (focal length outside [0.1, 10] x the image's larger side, or a
distortion coefficient above 1 in magnitude), or that triangulates no
baseline pair, is undone and started again with the generator's next draws.
The JAX package keeps the first start whatever it gives.

Input: the bundled insel images cut to 240x135 (the size of
tests/test_torch_run_scripts.py), ORB with sub-pixel keypoints at capacity
1,024, SfM seed 0 on the CPU. With those draws the first start from the
baseline (1, 2) registers all three views but leaves k2 ~ 3 and about
twice the sound focal length, on which the dense stage finds no pixel.
Bounds: exact counts, the bogus test itself, median reprojection < 0.5 px.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu_torch.cli.photogrammetrie import _normalize_camera_model
from sfm_mvs_pipeline_tpu_torch.models.cameras import make_intrinsics
from sfm_mvs_pipeline_tpu_torch.models.scene import Scene
from sfm_mvs_pipeline_tpu_torch.ops.matching import expand_binary_descriptors
from sfm_mvs_pipeline_tpu_torch.ops.orb import orb_features
from sfm_mvs_pipeline_tpu_torch.ops.pairs import make_pairs
from sfm_mvs_pipeline_tpu_torch.sfm import incremental as I
from sfm_mvs_pipeline_tpu_torch.utils.images import list_images, load_gray_batch
from sfm_mvs_pipeline_tpu_torch.utils.stats import reprojection_errors

torch.set_num_threads(2)

INSEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_data", "insel")


@pytest.fixture(scope="module")
def insel_orb(tmp_path_factory):
    """The images as tests/test_torch_run_scripts.py writes them, loaded as
    the CLI loads them."""
    data = tmp_path_factory.mktemp("insel_small")
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        cv2.imwrite(str(data / name), cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA))
    paths = list_images(str(data))
    imgs, _ = load_gray_batch(paths)
    f = orb_features(torch.from_numpy(imgs), max_features=1024)
    return (paths, f["keypoints"].numpy(), expand_binary_descriptors(f["descriptors"]).numpy(),
            f["valid"].numpy())


def _reconstruct(insel_orb):
    paths, kps, descs, valid = insel_orb
    intr = make_intrinsics(240, 135).numpy().astype(np.float64)
    scene = Scene.create(paths, (240, 135), kps, descs, valid, intr,
                         camera_model=_normalize_camera_model("simple-radial"))
    logs = []
    stats = I.reconstruct(scene, make_pairs("unordered", 3),
                          I.SfMConfig(seed=0, binary_descriptors=True), log=logs.append,
                          device="cpu")
    return scene, stats, logs


def test_bogus_intrinsics_bounds():
    good = np.array([[300.0, 120, 67.5, 0.3, -0.9, 0.01, 0.0]])
    assert not I.bogus_intrinsics(good, 240.0).any()
    for col, value in ((0, 0.09 * 240), (0, 10.5 * 240), (3, 1.01), (4, -3.0), (6, 1.5)):
        bad = good.copy()
        bad[0, col] = value
        assert I.bogus_intrinsics(bad, 240.0).all(), (col, value)


def test_first_start_alone_is_bogus(insel_orb, monkeypatch):
    """With one attempt the first start stands, as in the JAX package: all
    three views, bogus intrinsics."""
    monkeypatch.setattr(I, "_BASELINE_ATTEMPTS", 1)
    scene, stats, _ = _reconstruct(insel_orb)
    assert stats["views"] == 3 and stats["attempts"] == 1
    assert I.bogus_intrinsics(scene.intrinsics, 240.0).all(), scene.intrinsics


def test_restart_recovers_a_sound_start(insel_orb):
    scene, stats, logs = _reconstruct(insel_orb)
    abandoned = [m for m in logs if "abandoned" in m]
    assert stats["views"] == 3 and int(scene.recovered.sum()) == 3
    assert stats["attempts"] == len(abandoned) + 1 >= 2, logs
    assert not I.bogus_intrinsics(scene.intrinsics, 240.0).any(), scene.intrinsics
    assert np.median(reprojection_errors(scene)) < 0.5
