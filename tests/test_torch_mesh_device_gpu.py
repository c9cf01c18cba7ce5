"""Meshing on the card against the same code on the CPU
(mvs/mesh.py): the raw mesh soup built and clustered on cuda:0 and on
"cpu" from the same inputs.

Inputs: tests/test_torch_mvs.py's two-plane scene (its depth maps and
poses; colours from its texture before the blur, which would need cv2),
exact and with test_mesh_steps_match_jax's noise (2% of depth, 10% of the
pixels invalid); and cluster_vertices alone on ~2 M random vertices at a
cell that packs face keys into one int64 and at one whose > 2 M clusters
take the row-wise unique. Tolerances, each with its reason:
  * faces after every logged step equal, the final faces equal, order
    included: masks, the cumsum remap, sorts and uniques are integer work,
    and the cluster keys divide and floor the same float32 (or float64)
    vertices with IEEE division on both devices;
  * vertices within 1e-6 of the mesh's extent: the cluster means sum in
    float64 with atomics on the card, in another order than the CPU's
    (~1e-16 relative), and the card's back-projection may round its float32
    products differently in the last bit (~1e-7);
  * colours within 1, and at least 99.9% exact: a colour mean whose
    other-order float64 sum falls on the other side of an integer
    truncates to its neighbour.
This file imports no JAX, so on the card it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_mesh_device_gpu.py
"""

import re

import numpy as np
import pytest
import torch

H, W, F = 120, 160, 140.0
Z_BG, Z_FG = 12.0, 8.0
STEPS = ["raw mesh", "clustered", "small components removed", "holes closed", "cleaned"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def _scene():
    """tests/test_mvs.py::_render's depth maps and the scene fixture's
    poses (the same draws of default_rng(5)), with RGB colours."""
    rng = np.random.default_rng(5)
    centers = np.array([[-0.6, 0, 0], [-0.3, 0, 0], [0, 0, 0], [0.3, 0, 0], [0.6, 0, 0]])
    tex = rng.random((512, 512)).astype(np.float32)
    rgbs, depths = [], []
    for C in centers:
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        rx, ry = (xs - W / 2) / F, (ys - H / 2) / F
        Xf, Yf = C[0] + rx * (Z_FG - C[2]), C[1] + ry * (Z_FG - C[2])
        fg = (np.abs(Xf) < 1.5) & (np.abs(Yf) < 1.5)
        X = np.where(fg, Xf, C[0] + rx * (Z_BG - C[2]))
        Y = np.where(fg, Yf, C[1] + ry * (Z_BG - C[2]))
        ui = ((X * 0.1 + 0.5) % 1.0 * 511).astype(int)
        vi = ((Y * 0.1 + 0.5) % 1.0 * 511).astype(int)
        rgbs.append(np.repeat((tex[vi, ui] * 255).astype(np.uint8)[..., None], 3, axis=-1))
        depths.append(np.where(fg, Z_FG - C[2], Z_BG - C[2]))
    poses = np.zeros((5, 6), np.float32)
    poses[:, 3:] = -centers
    poses[:, :3] = rng.normal(scale=0.002, size=(5, 3))
    intr = np.array([F, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    return np.stack(depths).astype(np.float32), poses, intr, np.stack(rgbs)


def _same_mesh(got, want):
    """got (card) against want (CPU) under the module's tolerances."""
    Vg, Fg, Cg = got
    Vw, Fw, Cw = want
    np.testing.assert_array_equal(Fg, Fw)
    assert Vg.shape == Vw.shape and Vg.dtype == Vw.dtype
    assert np.abs(Vg - Vw).max() <= 1e-6 * np.abs(Vw).max()
    assert Cg.shape == Cw.shape and Cg.dtype == Cw.dtype == np.uint8
    diff = np.abs(Cg.astype(int) - Cw.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())


@pytest.mark.gpu
@pytest.mark.parametrize("noise", [0.0, 0.02], ids=["exact", "noisy"])
def test_mesh_on_the_card_matches_the_cpu(card, noise):
    from sfm_mvs_pipeline_tpu_torch.mvs.mesh import mesh_from_depth_maps
    from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

    gt, poses, intr, rgbs = _scene()
    rng = np.random.default_rng(7)
    depth = (gt * (1 + noise * rng.standard_normal(gt.shape))).astype(np.float32)
    valids = rng.random(gt.shape) > (0.1 if noise else 0.0)
    logs, meshes, counters = {}, {}, {}
    for dev in (card, "cpu"):
        logs[dev] = []
        stage_timer.enable()
        try:
            meshes[dev] = mesh_from_depth_maps(depth, valids, poses, intr, rgbs, device=dev,
                                               log=logs[dev].append)
        finally:
            stage_timer.enable(False)
        counters[dev] = stage_timer.counters()

    def faces(lines):
        return [next(int(m.group(1)) for ln in lines
                     if (m := re.search(re.escape(k) + r": \d+ verts, (\d+) faces", ln)))
                for k in STEPS]

    assert faces(logs[card]) == faces(logs["cpu"])
    assert len(meshes["cpu"]["faces"]) > 1000
    _same_mesh(*([meshes[d][k] for k in ("vertices", "faces", "colors")] for d in (card, "cpu")))
    raw = counters["cpu"]["mesh raw vertices"]
    assert counters[card] == {"mesh raw vertices": raw, "mesh device vertices": raw}
    assert "mesh device vertices" not in counters["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [0.01, 0.002], ids=["packed", "rows"])
def test_cluster_vertices_on_the_card_matches_the_cpu(card, cell):
    from sfm_mvs_pipeline_tpu_torch.mvs.mesh import cluster_vertices

    rng = np.random.default_rng(11)
    n = 2_200_000
    V = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    faces = rng.integers(0, n, (4_000_000, 3))
    faces[::5] = faces[1::5][: len(faces[::5])]  # repeated faces to drop
    C = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    got = cluster_vertices(*(torch.as_tensor(x, device=card) for x in (V, faces, C)), cell)
    want = cluster_vertices(V, faces, C, cell)
    assert (len(want[0]) > 2_000_000) == (cell == 0.002)  # the branch the case names
    _same_mesh(got, want)
