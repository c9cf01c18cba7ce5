"""The port's scene checkpoint (utils/checkpoint.py): members stored
without deflate, in the .npz + .json format the JAX package reads.

  * every array round-trips exactly, dtype and shape kept, on a scene at
    ORB-like capacity whose invalid slots hold data (as ORB's do);
  * every member is stored (no deflate), and the file is a plain .npz:
    np.load and the JAX package's load_scene read it, equal array by array;
  * a file the old writer made (np.savez_compressed, deflated) still loads
    to the same scene;
  * a resumed dense job (-Presume= --dense --sgm --mesh --colored, the
    insel images cut to 240x135, on the CPU) writes the same bytes from the
    old file as from the new one, its re-saved scene included.
"""

import json
import os
import zipfile

import cv2
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu_torch.cli.app import main as t_main
from sfm_mvs_pipeline_tpu_torch.models.scene import Scene
from sfm_mvs_pipeline_tpu_torch.utils import checkpoint as C

torch.set_num_threads(2)

INSEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_data",
                     "insel")


def _old_save(scene, path: str) -> None:
    """The writer as it was: every member deflated."""
    np.savez_compressed(path, **{f: getattr(scene, f) for f in C._ARRAY_FIELDS})
    with open(path + ".json", "w") as f:
        json.dump({"image_paths": list(scene.image_paths), "image_size": list(scene.image_size),
                   "camera_model": scene.camera_model, "version": 1}, f)


@pytest.fixture(scope="module")
def orb_like_scene():
    """3 shots at capacity 4,096 with +-1 descriptors of D = 256, 700-900
    valid slots each and data in every invalid slot, 50 points."""
    rng = np.random.default_rng(5)
    S, F = 3, 4096
    valid = np.zeros((S, F), bool)
    for s, n in enumerate((700, 900, 812)):
        valid[s, :n] = True
    scene = Scene.create([f"{i}.jpg" for i in range(S)], (1920, 1080),
                         rng.uniform(0, 1900, (S, F, 2)),
                         rng.integers(0, 2, (S, F, 256)) * 2.0 - 1.0, valid,
                         np.array([1680.0, 960, 540, 0.01, 0, 0, 0]))
    scene.add_points(rng.normal(size=(50, 3)),
                     [[(0, i, scene.keypoints[0, i]), (1, i, scene.keypoints[1, i])]
                      for i in range(50)])
    scene.poses[:] = rng.normal(size=(S, 6))
    scene.recovered[:] = True
    scene.colors = rng.integers(0, 255, (50, 4)).astype(np.uint8)
    return scene


@pytest.fixture(scope="module")
def saved(orb_like_scene, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "scene.npz")
    C.save_scene(orb_like_scene, path)
    return path


@pytest.mark.parametrize("field", C._ARRAY_FIELDS)
def test_every_array_round_trips_exactly(orb_like_scene, saved, field):
    back = C.load_scene(saved)
    want, got = getattr(orb_like_scene, field), getattr(back, field)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_metadata_round_trips(orb_like_scene, saved):
    back = C.load_scene(saved)
    assert back.image_paths == orb_like_scene.image_paths
    assert back.image_size == orb_like_scene.image_size
    assert back.camera_model == orb_like_scene.camera_model


def test_members_are_stored_in_a_plain_npz(saved):
    with zipfile.ZipFile(saved) as z:
        infos = z.infolist()
    assert sorted(i.filename for i in infos) == sorted(f + ".npy" for f in C._ARRAY_FIELDS)
    assert {i.compress_type for i in infos} == {zipfile.ZIP_STORED}
    with np.load(saved) as z:
        assert z["descriptors"].shape == (3, 4096, 256)


def test_the_jax_package_reads_the_port_s_file(orb_like_scene, saved):
    from sfm_mvs_pipeline_tpu.utils.checkpoint import load_scene as j_load

    back = j_load(saved)
    for f in C._ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), getattr(orb_like_scene, f))
    assert back.image_size == orb_like_scene.image_size


def test_a_file_of_the_old_writer_loads_to_the_same_scene(orb_like_scene, tmp_path):
    path = str(tmp_path / "old.npz")
    _old_save(orb_like_scene, path)
    with zipfile.ZipFile(path) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_DEFLATED}
    back = C.load_scene(path)
    for f in C._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(orb_like_scene, f))


def test_a_resumed_dense_job_is_the_same_from_the_old_and_the_new_file(tmp_path):
    data = tmp_path / "insel_small"
    data.mkdir()
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        cv2.imwrite(str(data / name), cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA))
    sparse = tmp_path / "sparse"
    assert t_main(["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={sparse}", "-Pdevice=cpu",
                   "-Pfeature-limit=512", "-Ploglevel=4"]) == 0
    new = str(sparse / "scene.npz")
    old = str(tmp_path / "old" / "scene.npz")
    os.makedirs(os.path.dirname(old))
    _old_save(C.load_scene(new), old)
    outs = {}
    for tag, scene in (("new", new), ("old", old)):
        out = tmp_path / f"dense_{tag}"
        assert t_main(["-Prun=photogrammetrie", f"-Presume={scene}", f"-Pout={out}",
                       "-Pdevice=cpu", "-Ploglevel=4", "--dense", "--sgm", "--mesh",
                       "--colored"]) == 0
        outs[tag] = out
    names = sorted(os.listdir(outs["new"]))
    assert names == sorted(os.listdir(outs["old"]))
    assert {"pointcloud_dense.ply", "mesh_dense.ply", "scene.npz"} <= set(names)
    for name in names:
        with open(outs["new"] / name, "rb") as a, open(outs["old"] / name, "rb") as b:
            assert a.read() == b.read(), name
