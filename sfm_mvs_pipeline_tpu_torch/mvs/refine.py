"""Photometric mesh refinement (--refine-mesh).

Replaces openMVS RefineMesh (ref: src/photogrammetrie/mvs/MVS.cpp:157-172,
gated by the --refine-mesh flag, src/cli/PhotogrammetrieCli.cpp:227; the
usage text warns it "kann ebenso zu schlechterem Mesh fuehren" —
PhotogrammetrieCli.cpp:453).

Batched formulation instead of openMVS's per-vertex gradient descent:
every vertex searches a fixed ladder of displacements along its normal and
keeps the one maximizing ZNCC photo-consistency between its two best
views — a batched (N_vertices x K_offsets x P_patch) evaluation per view
pair, all dense array ops. Vertices whose best score does not beat their
undisplaced score stay put, so refinement can only improve the photometric
objective it optimizes.

Port of sfm_mvs_pipeline_tpu/mvs/refine.py: the JAX package's jitted ZNCC
scorer becomes torch ops on the device; the grouping by view pair stays
host numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)  # magnitude = 2*area (weights)
    n = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(n, faces[:, i], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def _vertex_view_scores(vertices, normals, poses, intr, image_hw, device):
    """(V, N) view-quality score per vertex (cos / z^2; -1 = not visible)."""
    from sfm_mvs_pipeline_tpu_torch.models.cameras import project_points
    from sfm_mvs_pipeline_tpu_torch.ops.pose import camera_center

    h, w = image_hw
    pts = torch.as_tensor(vertices, dtype=torch.float32, device=device)
    poses_d = torch.as_tensor(poses, dtype=torch.float32, device=device)
    uv, z = project_points(
        poses_d, torch.as_tensor(intr, dtype=torch.float32, device=device),
        pts[None].expand(len(poses), *pts.shape),
    )
    uv = uv.cpu().numpy()
    z = z.cpu().numpy()
    centers = camera_center(poses_d).cpu().numpy()
    to_cam = centers[:, None, :] - vertices[None]
    to_cam /= np.maximum(np.linalg.norm(to_cam, axis=-1, keepdims=True), 1e-12)
    cosang = np.einsum("vnk,nk->vn", to_cam, normals)
    m = 2.0  # patch margin in px
    inside = (
        (uv[..., 0] >= m) & (uv[..., 0] <= w - 1 - m)
        & (uv[..., 1] >= m) & (uv[..., 1] <= h - 1 - m)
        & (z > 1e-6)
    )
    return np.where(inside & (cosang > 0.05), cosang / np.maximum(z, 1e-6) ** 2, -1.0)


def _best_offsets(p, n, pose_a, pose_b, gray_a, gray_b, intr, offs, dxy, zero: int):
    """Per vertex, the index of the normal offset that maximises ZNCC
    between its patches in views a and b; `zero` (no move) unless some
    offset beats it by 1e-4."""
    from sfm_mvs_pipeline_tpu_torch.models.cameras import project_points
    from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import _bilinear_hw

    n_off = offs.shape[0]
    cand = p[:, None, :] + n[:, None, :] * offs[None, :, None]  # (N, K, 3)

    def patches(pose, gray):
        uv, z = project_points(pose, intr, cand.reshape(1, -1, 3))
        pix = uv[0][:, None, :] + dxy[None]  # (N*K, P, 2)
        vals, inside = _bilinear_hw(gray, pix[..., 0], pix[..., 1])
        return vals, inside.all(-1) & (z[0] > 1e-6)

    pa, ia = patches(pose_a, gray_a)
    pb, ib = patches(pose_b, gray_b)
    ma = pa - pa.mean(-1, keepdim=True)
    mb = pb - pb.mean(-1, keepdim=True)
    denom = torch.sqrt((ma * ma).sum(-1) * (mb * mb).sum(-1)) + 1e-9
    zncc = torch.where(ia & ib, (ma * mb).sum(-1) / denom, torch.full_like(denom, -2.0))
    zncc = zncc.reshape(-1, n_off)
    kbest = torch.argmax(zncc, dim=1)
    improve = torch.gather(zncc, 1, kbest[:, None])[:, 0] > zncc[:, zero] + 1e-4
    return torch.where(improve, kbest, torch.full_like(kbest, zero))


def refine_mesh_photometric(
    vertices: np.ndarray,
    faces: np.ndarray,
    poses: np.ndarray,  # (V, 6)
    intr: np.ndarray,  # (7,)
    grays: np.ndarray,  # (V, H, W) float in [0, 1]
    n_offsets: int = 9,
    rel_range: float = 0.5,
    patch_radius: int = 1,
    log=lambda *a: None,
    device=None,
) -> np.ndarray:
    """Returns refined vertex positions (same shape as `vertices`); the
    scoring runs on `device` (default: the card; raises without one)."""
    from sfm_mvs_pipeline_tpu_torch import resolve_device

    if len(vertices) == 0 or len(faces) == 0 or len(poses) < 2:
        return vertices
    dev = resolve_device(device)

    normals = vertex_normals(vertices, faces)
    scores = _vertex_view_scores(vertices, normals, poses, intr, grays.shape[1:], dev)
    order = np.argsort(-scores, axis=0)
    b1, b2 = order[0], order[1]  # two best views per vertex
    ok = (np.take_along_axis(scores, order[1:2], 0)[0] > 0)

    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    elen = np.linalg.norm(vertices[edges[:, 0]] - vertices[edges[:, 1]], axis=1)
    delta = float(np.median(elen)) * rel_range
    offsets = np.linspace(-delta, delta, n_offsets)
    zero_k = int(np.argmin(np.abs(offsets)))
    offsets[zero_k] = 0.0  # ensure the identity candidate is present

    r = patch_radius
    dy, dx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), indexing="ij")
    dxy = np.stack([dx.ravel(), dy.ravel()], -1).astype(np.float32)  # (P, 2)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    intr_d, offs_d, dxy_d, grays_d = f32(intr), f32(offsets), f32(dxy), f32(grays)

    out = vertices.copy()
    pair_key = b1.astype(np.int64) * len(poses) + b2
    moved = 0
    for key in np.unique(pair_key[ok]):
        va, vb = int(key // len(poses)), int(key % len(poses))
        sel = np.nonzero(ok & (pair_key == key))[0]
        k_np = _best_offsets(
            f32(vertices[sel]), f32(normals[sel]), f32(poses[va]), f32(poses[vb]),
            grays_d[va], grays_d[vb], intr_d, offs_d, dxy_d, zero_k,
        ).cpu().numpy()
        out[sel] = vertices[sel] + normals[sel] * offsets[k_np][:, None]
        moved += int((k_np != zero_k).sum())
    log(f"refine-mesh: moved {moved}/{len(vertices)} vertices "
        f"(search +-{delta:.4g})")
    return out
