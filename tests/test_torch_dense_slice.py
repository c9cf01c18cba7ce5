"""The port's dense slice against the JAX package, and its guards.

The port's CLI runs sparse + dense on the bundled insel images at 240x135
(-Pfeature-limit=512 --dense --sgm --mesh --colored --stats --artifacts)
and writes one scene.npz. Both packages' run_mvs then densify that scene
with --sgm on the default rect engine; the JAX package takes its
single-device branch (jax.devices() is cut to one device in that test, as
the port has one device), where --sgm runs the lax.scan SGM. Bounds: per
view, where both depth maps are valid, the median relative difference is
<= 1% and the valid masks agree on >= 95% of pixels; the dense point
counts are within 10%. The port computes in float32 on the CPU here.
"""

import os
import shutil
import tempfile

import cv2
import jax
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu.mvs import pipeline as JPIPE
from sfm_mvs_pipeline_tpu.utils.checkpoint import load_scene as j_load
from sfm_mvs_pipeline_tpu_torch.cli.app import main as t_main
from sfm_mvs_pipeline_tpu_torch.mvs import pipeline as TPIPE
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer
from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene as t_load
from sfm_mvs_pipeline_tpu_torch.utils.ply import read_ply

torch.set_num_threads(2)

INSEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_data", "insel")
DENSE_FLAGS = ["--dense", "--sgm", "--mesh", "--colored", "--stats", "--artifacts"]


@pytest.fixture(scope="module")
def insel_run(tmp_path_factory):
    """The port's CLI, sparse + dense, on insel at 240x135."""
    tmp = tmp_path_factory.mktemp("dense_slice")
    data = tmp / "insel_small"
    data.mkdir()
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        cv2.imwrite(str(data / name), cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA))
    out = tmp / "out_t"
    rc = t_main(["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out}", "-Pdevice=cpu",
                 "-Pfeature-limit=512", "-Ploglevel=4", *DENSE_FLAGS])
    assert rc == 0
    return tmp, out


def test_cli_writes_dense_artifacts(insel_run):
    _, out = insel_run
    names = set(os.listdir(out))
    for name in ("pointcloud_sparse.ply", "cameras_recovered.ply", "scene.npz",
                 "pointcloud_dense.ply", "mesh_dense.ply", "mesh_dense.png",
                 "reprojectionerror.stat.csv", "app.stat.csv", "scene.txt",
                 "depth_0000.npy", "depth_0001.npy", "depth_0002.npy"):
        assert name in names, name
    dense = read_ply(str(out / "pointcloud_dense.ply"))
    mesh = read_ply(str(out / "mesh_dense.ply"))
    assert len(dense["points"]) > 1000 and len(mesh["faces"]) > 1000
    assert np.isfinite(dense["points"]).all()
    head = open(out / "mesh_dense.ply", "rb").read(300).decode("latin1")
    assert "TextureFile mesh_dense.png" in head and "texcoord" in head


def test_run_mvs_port_vs_jax(insel_run, monkeypatch):
    tmp, out = insel_run
    scene_t = t_load(str(out / "scene.npz"))
    scene_j = j_load(str(out / "scene.npz"))
    assert int(scene_t.recovered.sum()) == 3
    out_t, out_j = tmp / "mvs_t", tmp / "mvs_j"
    out_t.mkdir()
    out_j.mkdir()
    kw = dict(use_sgm=True, mesh=True, texture=True, keep_artifacts=True)
    stage_timer.enable()
    try:
        res_t = TPIPE.run_mvs(scene_t, str(out_t), TPIPE.MVSConfig(**kw), device="cpu")
        stages = stage_timer.report()
    finally:
        stage_timer.enable(False)
    # 3 views x 2 neighbours: each pair sweeps twice (before and after SGM)
    assert stages["rect sweep"][1] == 12 and stages["sgm"][1] == 6, stages
    assert {"load + undistort", "consensus", "fusion", "mesh", "texture", "texture atlas"} <= set(stages)
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    res_j = JPIPE.run_mvs(scene_j, str(out_j), JPIPE.MVSConfig(**kw))
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))

    for i in range(3):
        d_t, v_t = res_t["depth_maps"][i], res_t["valids"][i]
        d_j, v_j = res_j["depth_maps"][i], res_j["valids"][i]
        both = v_t & v_j
        assert both.mean() > 0.3, (i, both.mean())
        rel = np.abs(d_t - d_j)[both] / d_j[both]
        assert np.median(rel) <= 0.01, (i, np.median(rel))
        assert (v_t == v_j).mean() >= 0.95, (i, (v_t == v_j).mean())
    n_t, n_j = len(res_t["dense"]["points"]), len(res_j["dense"]["points"])
    assert abs(n_t - n_j) <= 0.1 * n_j, (n_t, n_j)
    assert len(res_t["mesh"]["faces"]) > 0


def test_cluster_vertices_int64_guard():
    """The packed cluster key (keys[0] * r1 + keys[1]) * r2 + keys[2]
    overflows int64 once r0 * r1 * r2 does; the JAX package packs without
    a check, the port raises a plain error instead."""
    from sfm_mvs_pipeline_tpu.mvs.mesh import cluster_vertices as j_cluster
    from sfm_mvs_pipeline_tpu_torch.mvs.mesh import cluster_vertices as t_cluster

    rng = np.random.default_rng(0)
    verts = rng.uniform(0, 1, (50, 3))
    faces = rng.integers(0, 50, (80, 3))
    cols = rng.integers(0, 255, (50, 3)).astype(np.uint8)
    for a, b in zip(t_cluster(verts, faces, cols, 0.2), j_cluster(verts, faces, cols, 0.2)):
        np.testing.assert_array_equal(a, b)
    far = np.array([[0.0, 0.0, 0.0], [1e7, 1e7, 1e7], [1e7, 0.0, 1.0]])
    tri = np.array([[0, 1, 2]])
    with pytest.raises(ValueError, match="int64"):
        t_cluster(far, tri, None, 1e-3)
    j_cluster(far, tri, None, 1e-3)  # the JAX package does not notice


def test_resume_stash_is_removed(insel_run, monkeypatch):
    """-Presume= from a checkpoint inside the output directory: the
    checkpoint is stashed in a temporary directory so the workdir wipe does
    not lose it. The port removes the stash when the run ends; the JAX
    package leaves it behind."""
    tmp, out = insel_run
    stash_root = tmp / "tmp_root"
    stash_root.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(stash_root))
    runs = {}
    for tag, main in (("t", t_main), ("j", None)):
        work = tmp / f"resume_{tag}"
        work.mkdir()
        for name in ("scene.npz", "scene.npz.json"):
            if (out / name).exists():
                (work / name).write_bytes((out / name).read_bytes())
        argv = ["-Prun=photogrammetrie", f"-Presume={work / 'scene.npz'}", f"-Pout={work}",
                "-Ploglevel=4"]
        if main is None:
            from sfm_mvs_pipeline_tpu.cli.app import main as j_main

            assert j_main(argv) == 0
        else:
            assert main(argv + ["--dense", "--sgm", "-Pdevice=cpu"]) == 0
        runs[tag] = sorted(p for p in os.listdir(stash_root) if p.startswith("sfm_resume_"))
        for p in runs[tag]:
            shutil.rmtree(stash_root / p)
        assert (work / "scene.npz").exists() and (work / "pointcloud_sparse.ply").exists()
    assert runs["t"] == [], runs
    assert len(runs["j"]) == 1, runs
    assert (tmp / "resume_t" / "pointcloud_dense.ply").exists()
