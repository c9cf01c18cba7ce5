"""The port's host tier for -Prun=pcl-stats against the JAX package's:
the native C++ kd-tree and PLY writer (a copy of the JAX package's
native/src/native.cpp, built by the port's own loader), the numpy
fallbacks, the NN statistics and the pcl-stats CLI. Mirrors
tests/test_native.py and the pcl-stats cases of tests/test_cli.py.

Tolerances: kNN distances against a float64 brute force to rtol 1e-5,
atol 1e-6 (the kd-tree works in float32), as tests/test_native.py states;
the port's and the JAX package's pcl-stats outputs byte-equal (the same
C++ source and the same numpy on both sides). Also: the port's entry
points refuse to run without a card unless the CPU is asked for.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from sfm_mvs_pipeline_tpu.cli.app import main as j_main
from sfm_mvs_pipeline_tpu_torch import native
from sfm_mvs_pipeline_tpu_torch.cli import pcl_stats
from sfm_mvs_pipeline_tpu_torch.cli.app import main as t_main
from sfm_mvs_pipeline_tpu_torch.utils.args import AppArgs
from sfm_mvs_pipeline_tpu_torch.utils.ply import read_ply, write_ply_mesh, write_ply_points
from sfm_mvs_pipeline_tpu_torch.utils.stats import knn_distances

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _brute_kth(pts, k):
    d2 = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sqrt(np.sort(d2, axis=1)[:, k - 1])


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_native_knn_matches_brute_force(rng):
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    for k in (1, 4):
        np.testing.assert_allclose(native.knn_kth_distance(pts, k), _brute_kth(pts, k),
                                   rtol=1e-5, atol=1e-6)
    dk = native.knn_all_distances(pts, 4)
    np.testing.assert_allclose(dk[:, 3], _brute_kth(pts, 4), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dk[:, 0], _brute_kth(pts, 1), rtol=1e-5, atol=1e-6)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_native_knn_duplicate_points(rng):
    """Self-exclusion is by index, so exact duplicates report distance 0."""
    pts = np.repeat(rng.normal(size=(5, 3)).astype(np.float32), 2, axis=0)
    np.testing.assert_allclose(native.knn_kth_distance(pts, 1), 0.0, atol=1e-7)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_native_ply_roundtrip(tmp_path, rng):
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (64, 3)).astype(np.uint8)
    nrm = rng.normal(size=(64, 3)).astype(np.float32)
    faces = rng.integers(0, 64, (30, 3)).astype(np.int32)
    p = str(tmp_path / "m.ply")
    assert native.write_ply_native(p, pts, rgb, nrm, faces)
    r = read_ply(p)
    np.testing.assert_array_equal(r["points"], pts)
    np.testing.assert_array_equal(r["colors"][:, :3], rgb)
    np.testing.assert_array_equal(r["normals"], nrm)
    np.testing.assert_array_equal(r["faces"], faces)


def test_python_fallback_matches_native(tmp_path, rng):
    """With SFM_TORCH_NO_NATIVE set, knn_distances and the PLY writer take
    the numpy path, in a process that imports no JAX, and agree with the
    tier this process has."""
    pts = rng.normal(size=(128, 3))
    np.save(tmp_path / "pts.npy", pts)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from sfm_mvs_pipeline_tpu_torch import native\n"
        "from sfm_mvs_pipeline_tpu_torch.utils.stats import knn_distances\n"
        "from sfm_mvs_pipeline_tpu_torch.utils.ply import write_ply_points\n"
        "assert not native.available()\n"
        f"pts = np.load({str(tmp_path / 'pts.npy')!r})\n"
        f"np.save({str(tmp_path / 'd.npy')!r}, knn_distances(pts))\n"
        f"write_ply_points({str(tmp_path / 'py.ply')!r}, pts)\n"
        "assert 'jax' not in sys.modules\n"
    )
    env = dict(os.environ, SFM_TORCH_NO_NATIVE="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT, timeout=120)
    np.testing.assert_allclose(np.load(tmp_path / "d.npy"), knn_distances(pts), rtol=1e-5, atol=1e-6)
    write_ply_points(str(tmp_path / "any.ply"), pts)
    np.testing.assert_array_equal(read_ply(str(tmp_path / "py.ply"))["points"],
                                  read_ply(str(tmp_path / "any.ply"))["points"])


def test_write_ply_points_uses_some_path(tmp_path, rng):
    """Whichever tier is live, the public writers emit a readable file (an
    alpha channel takes the numpy path)."""
    pts = rng.normal(size=(10, 3))
    rgba = rng.integers(0, 255, (10, 4)).astype(np.uint8)
    write_ply_points(str(tmp_path / "a.ply"), pts, rgba)
    r = read_ply(str(tmp_path / "a.ply"))
    assert r["points"].shape == (10, 3) and r["colors"].shape[1] >= 3
    write_ply_mesh(str(tmp_path / "b.ply"), pts, rng.integers(0, 10, (4, 3)))
    assert read_ply(str(tmp_path / "b.ply"))["faces"].shape == (4, 3)


def test_knn_distances(rng):
    pts = rng.normal(size=(100, 3))
    dd = np.linalg.norm(pts[:, None] - pts[None], axis=2)
    np.fill_diagonal(dd, np.inf)
    np.testing.assert_allclose(knn_distances(pts), dd.min(axis=1), rtol=1e-5)


@pytest.mark.parametrize("mesh", [False, True])
def test_pcl_stats_cli_port_vs_jax(tmp_path, rng, mesh):
    """-Prun=pcl-stats through both CLIs on one cloud (or one mesh): the
    three outputs exist and are byte-equal between the packages; a mesh's
    quality PLY keeps its faces (the reference's writeToNeighborPLY)."""
    pts = rng.normal(size=(200, 3))
    faces = rng.integers(0, 200, (60, 3))
    outs = {}
    for tag, main in (("t", t_main), ("j", j_main)):
        d = tmp_path / tag
        d.mkdir()
        inp = str(d / "cloud.ply")
        if mesh:
            write_ply_mesh(inp, pts, faces)
        else:
            write_ply_points(inp, pts)
        assert main(["-Prun=pcl-stats", f"-Pinput={inp}", "-Ploglevel=4"]) == 0
        outs[tag] = {ext: (d / f"cloud.{ext}").read_bytes()
                     for ext in ("stats.csv", "neighbors.csv", "quality.ply")}
        q = read_ply(str(d / "cloud.quality.ply"))
        assert q["colors"].shape[1] >= 3
        if mesh:
            np.testing.assert_array_equal(q["faces"], faces)
    for ext in ("stats.csv", "neighbors.csv"):
        assert outs["t"][ext] == outs["j"][ext], ext
    # the PLY header's writer comment names its package; the payloads agree
    qt = read_ply(str(tmp_path / "t" / "cloud.quality.ply"))
    qj = read_ply(str(tmp_path / "j" / "cloud.quality.ply"))
    for k in ("points", "colors"):
        np.testing.assert_array_equal(qt[k], qj[k])


def test_pcl_stats_options_and_empty_input(tmp_path, rng):
    """-Pstats/-Pneighbors/-Pquality name the outputs (run-pcl-stats.sh
    passes all three); a cloud with no points exits 1."""
    inp = str(tmp_path / "c.ply")
    write_ply_points(inp, rng.normal(size=(50, 3)))
    names = {k: str(tmp_path / f"out_{k}") for k in ("stats", "neighbors", "quality")}
    args = AppArgs([f"-Pinput={inp}", "-Ploglevel=4"] + [f"-P{k}={v}" for k, v in names.items()])
    assert pcl_stats.main(args) == 0
    assert all(os.path.getsize(v) > 0 for v in names.values())
    empty = str(tmp_path / "e.ply")
    write_ply_points(empty, np.zeros((0, 3)))
    assert pcl_stats.main(AppArgs([f"-Pinput={empty}"])) == 1


def test_device_cuda_without_a_card_fails_plainly(tmp_path, capsys):
    """-Pdevice=cuda (the default) without a card exits non-zero with a
    plain message and leaves an existing output dir alone; the entry points
    raise the same error unless device="cpu" is given."""
    import torch

    from sfm_mvs_pipeline_tpu_torch import default_device, resolve_device
    from sfm_mvs_pipeline_tpu_torch.mvs.fusion import fuse_depth_maps
    from sfm_mvs_pipeline_tpu_torch.mvs.pipeline import run_mvs
    from sfm_mvs_pipeline_tpu_torch.sfm.ba import run_bundle_adjustment
    from sfm_mvs_pipeline_tpu_torch.sfm.incremental import reconstruct

    if torch.cuda.is_available():
        pytest.skip("a card is present: -Pdevice=cuda runs")
    out = tmp_path / "o"
    out.mkdir()
    (out / "keep.txt").write_text("x")
    for extra in ([], ["-Pdevice=cuda"]):
        argv = ["-Prun=photogrammetrie", f"-Pimage={ROOT}/sample_data/insel", f"-Pout={out}",
                "-Ploglevel=2", *extra]
        assert t_main(argv) != 0
        assert "no CUDA device" in capsys.readouterr().out
    assert (out / "keep.txt").exists()
    for call in (default_device, lambda: resolve_device(None),
                 lambda: reconstruct(None, None),
                 lambda: run_mvs(None, str(tmp_path)),
                 lambda: fuse_depth_maps(np.zeros((1, 2, 2)), np.zeros((1, 2, 2), bool),
                                         np.zeros((1, 6)), np.zeros(7)),
                 lambda: run_bundle_adjustment(*([np.zeros((0, 3))] * 9))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
