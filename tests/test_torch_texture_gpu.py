"""Texturing on the card against the same code on the CPU
(mvs/texture.py::build_texture_atlas on cuda:0 and on "cpu" from the same
inputs), at the dense cells' size: a ~300 k-face relief plane seen by 12
views at 1920x1080.

Tolerances, each with its reason:
  * texture coordinates exact: host numpy on both routes;
  * face views equal on >= 99.99% of faces: the card's matmuls and
    reductions may round the score's float32 products in another order, so
    two views whose scores tie to the last bit may swap;
  * on faces with the same view, atlas texels within 1 and >= 99.9% exact:
    a texel position that rounds differently in the last bit moves its
    float32 bilinear blend, and a blend next to a half rounds to its
    neighbour.
The counters: "texture device faces" equals "texture faces" on the card and
is absent on the CPU. This file imports no JAX, so on the card it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_texture_gpu.py
"""

import numpy as np
import pytest
import torch

H, W, F = 1080, 1920, 1680.0
VIEWS = 12
GRID = 388  # vertices a side: 2 x 387^2 = 299,538 faces


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def _scene():
    """The relief z = 10 + 0.3 sin(x) cos(y) over [-4, 4] x [-2.5, 2.5],
    faces wound toward the cameras, and 12 views along x at z = 0 with
    small rotations, each a random image."""
    rng = np.random.default_rng(3)
    xs, ys = np.meshgrid(np.linspace(-4, 4, GRID), np.linspace(-2.5, 2.5, GRID))
    verts = np.stack([xs, ys, 10 + 0.3 * np.sin(xs) * np.cos(ys)], -1).reshape(-1, 3)
    a = (np.arange(GRID * GRID).reshape(GRID, GRID))[:-1, :-1].ravel()
    faces = np.concatenate([np.stack([a, a + GRID, a + 1], 1),
                            np.stack([a + 1, a + GRID, a + GRID + 1], 1)])
    poses = np.zeros((VIEWS, 6), np.float32)
    poses[:, :3] = rng.normal(scale=0.01, size=(VIEWS, 3))
    poses[:, 3] = -np.linspace(-1.1, 1.1, VIEWS)
    intr = np.array([F, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    images = rng.integers(0, 256, (VIEWS, H, W, 3), dtype=np.uint8)
    return verts, faces, poses, intr, images


def _blocks(atlas, n, block=8):
    """The atlas's first n blocks as (n, block * block, 3), in face order."""
    rows, cols = atlas.shape[0] // block, atlas.shape[1] // block
    b = atlas.reshape(rows, block, cols, block, 3).transpose(0, 2, 1, 3, 4)
    return b.reshape(rows * cols, block * block, 3)[:n]


@pytest.mark.gpu
def test_texture_atlas_on_the_card_matches_the_cpu(card):
    from sfm_mvs_pipeline_tpu_torch.mvs.texture import build_texture_atlas
    from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

    verts, faces, poses, intr, images = _scene()
    nf = len(faces)
    got, counters = {}, {}
    for dev in (card, "cpu"):
        stage_timer.enable()
        try:
            got[dev] = build_texture_atlas(verts, faces, poses, intr, images, device=dev)
        finally:
            stage_timer.enable(False)
        counters[dev] = stage_timer.counters()
    g, w = got[card], got["cpu"]
    np.testing.assert_array_equal(g["uv"], w["uv"])
    cols = int(np.ceil(np.sqrt(nf)))
    assert g["atlas"].shape == w["atlas"].shape == (-(-nf // cols) * 8, cols * 8, 3)
    assert g["atlas"].dtype == np.uint8
    assert (w["face_view"] >= 0).mean() > 0.99  # the plane is seen: a real comparison
    same = g["face_view"] == w["face_view"]
    assert same.mean() >= 0.9999, same.mean()
    diff = np.abs(_blocks(g["atlas"], nf)[same].astype(int)
                  - _blocks(w["atlas"], nf)[same].astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())
    assert counters[card] == {"texture faces": nf, "texture device faces": nf}
    assert counters["cpu"] == {"texture faces": nf}
