"""Plane-sweep stereo: multi-view cost volumes + WTA depth maps.

Port of sfm_mvs_pipeline_tpu/mvs/plane_sweep.py (the stand-in for
openMVS's dense reconstruction, ref: src/photogrammetrie/mvs/MVS.cpp:112-120).
For reference view r and neighbour n, a fronto-parallel plane at depth d
induces the homography
    H_n(d) = K_n (R_rel + t_rel [0,0,1]/d) K_r^-1
Pixels of r are warped into n via H_n(d) and compared with ZNCC over a box
window (separable box sums from cumulative sums).

The public functions keep the JAX layout: cost volumes are (D, H, W). The
JAX package's `lax.map` over depths becomes batched torch code over chunks
of depths (`level_chunks` bounds the chunk by element count, so a 1080p
volume never holds more than a few (chunk, H, W) temporaries at once).
Gathers are flat-index `torch` indexing, not `grid_sample`, whose edge and
align_corners rules differ from the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.models.cameras import intrinsics_to_K
from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat, relative_pose

# elements of one (levels, H, W) chunk: ~16 levels at 1920x1080
_CHUNK_ELEMS = 1 << 25


def level_chunks(n_levels: int, h: int, w: int):
    """Slices of the level axis whose (chunk, H, W) blocks stay under
    _CHUNK_ELEMS elements."""
    step = max(1, _CHUNK_ELEMS // max(h * w, 1))
    return [slice(i, min(i + step, n_levels)) for i in range(0, n_levels, step)]


def _edge_pad(x: torch.Tensor, before: int, after: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    idx = torch.arange(-before, n + after, device=x.device).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def _box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box sum over the last two axes (same-size, edge-padded)."""
    k = 2 * radius + 1
    x = torch.cumsum(_edge_pad(x, radius + 1, radius, x.dim() - 2), dim=-2)
    x = x[..., k:, :] - x[..., :-k, :]
    x = torch.cumsum(_edge_pad(x, radius + 1, radius, x.dim() - 1), dim=-1)
    return x[..., :, k:] - x[..., :, :-k]


def _bilinear_hw(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear sample img (H, W) at float coords of any shape; returns
    (vals, inside). Taps are flat-index gathers into the raveled image with
    clamped coordinates, as in the JAX package."""
    h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    inside = (x >= 0) & (x <= w - 1.001) & (y >= 0) & (y <= h - 1.001)
    flat = img.reshape(-1)

    def at(yy, xx):
        return flat[yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)]

    v = (
        at(y0i, x0i) * (1 - fx) * (1 - fy)
        + at(y0i, x0i + 1) * fx * (1 - fy)
        + at(y0i + 1, x0i) * (1 - fx) * fy
        + at(y0i + 1, x0i + 1) * fx * fy
    )
    return v, inside


def pixel_grid(h: int, w: int, dtype, device) -> torch.Tensor:
    """Homogeneous pixel coordinates (3, H*W): rows x, y, 1."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys, torch.ones_like(xs)], 0).reshape(3, -1)


def dehomogenize(q: torch.Tensor, h: int, w: int):
    """(..., 3, H*W) homogeneous points -> x, y (..., H, W), with the JAX
    package's guard against a vanishing third coordinate."""
    z = q[..., 2, :]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    lead = q.shape[:-2]
    return (q[..., 0, :] / z).reshape(*lead, h, w), (q[..., 1, :] / z).reshape(*lead, h, w)


def zncc_cost(ref, warped, r_mean, r_var, window_radius: int):
    """(1 - ZNCC)/2 in [0, 1] of `warped` (..., H, W) against the reference
    window statistics."""
    area = (2 * window_radius + 1) ** 2
    w_sum = _box_filter(warped, window_radius)
    w_sq = _box_filter(warped * warped, window_radius)
    rw = _box_filter(ref * warped, window_radius)
    w_mean = w_sum / area
    w_var = torch.clamp(w_sq / area - w_mean * w_mean, min=1e-8)
    cov = rw / area - r_mean * w_mean
    zncc = cov / torch.sqrt(r_var * w_var)
    return (1.0 - torch.clamp(zncc, -1.0, 1.0)) * 0.5


def window_stats(ref: torch.Tensor, window_radius: int):
    """Reference-side window mean and variance (candidate-invariant)."""
    area = (2 * window_radius + 1) ** 2
    r_mean = _box_filter(ref, window_radius) / area
    r_sq = _box_filter(ref * ref, window_radius)
    return r_mean, torch.clamp(r_sq / area - r_mean * r_mean, min=1e-8)


def plane_homographies(
    pose_r: torch.Tensor, pose_n: torch.Tensor, K_r: torch.Tensor, K_n: torch.Tensor,
    depths: torch.Tensor,
) -> torch.Tensor:
    """(D, 3, 3) homographies ref->neighbor for fronto-parallel planes."""
    rel = relative_pose(pose_r, pose_n)
    R = aa_to_rotmat(rel[:3])
    t = rel[3:]
    n_vec = torch.tensor([0.0, 0.0, 1.0], dtype=pose_r.dtype, device=pose_r.device)
    Kr_inv = torch.linalg.inv(K_r)
    # plane n.X = d in the ref frame; X_n = R X_r + t = (R + t n^T / d) X_r
    H = R[None, :, :] + t[None, :, None] * n_vec[None, None, :] / depths[:, None, None]
    return K_n[None] @ H @ Kr_inv[None]


def sweep_cost_volume(
    ref_img: torch.Tensor,  # (H, W) grayscale f32
    nbr_imgs: torch.Tensor,  # (N, H, W)
    pose_r: torch.Tensor,
    poses_n: torch.Tensor,  # (N, 6)
    intr: torch.Tensor,  # (7,) shared intrinsics (scaled to this resolution)
    depths: torch.Tensor,  # (D,) plane depths
    window_radius: int = 3,
    nbr_valid: torch.Tensor | None = None,  # (N,) bool — False = padded slot
) -> torch.Tensor:
    """Cost volume (D, H, W): mean over the best half of the neighbours of
    (1 - ZNCC)/2 in [0, 1]. Out-of-view samples cost 1 (worst).

    nbr_valid gives fixed-capacity neighbour lists: padded slots cost 1
    everywhere and the best-half aggregation counts only valid neighbours.
    """
    h, w = ref_img.shape
    K = intrinsics_to_K(intr)
    pix = pixel_grid(h, w, ref_img.dtype, ref_img.device)
    r_mean, r_var = window_stats(ref_img, window_radius)

    costs = torch.empty((nbr_imgs.shape[0], depths.shape[0], h, w),
                        dtype=ref_img.dtype, device=ref_img.device)
    for j in range(nbr_imgs.shape[0]):
        Hs = plane_homographies(pose_r, poses_n[j], K, K, depths)  # (D, 3, 3)
        for sl in level_chunks(depths.shape[0], h, w):
            xq, yq = dehomogenize(Hs[sl] @ pix, h, w)  # (d, H, W)
            warped, inside = _bilinear_hw(nbr_imgs[j], xq, yq)
            cost = zncc_cost(ref_img, warped, r_mean, r_var, window_radius)
            costs[j, sl] = torch.where(inside, cost, torch.ones_like(cost))

    n = costs.shape[0]
    if nbr_valid is None:
        # robust aggregation: mean of the best half of neighbors per (d, px)
        k = max(1, (n + 1) // 2)
        best = torch.topk(costs, k, dim=0, largest=False, sorted=True).values
        return best.mean(dim=0)
    # masked variant: padded neighbors cost 1 (sort last); take the best
    # ceil(n_valid/2) by position after an ascending sort along N
    costs = torch.where(nbr_valid[:, None, None, None], costs, torch.ones_like(costs))
    srt = torch.sort(costs, dim=0).values
    n_valid = nbr_valid.to(costs.dtype).sum()
    k_dyn = torch.clamp(torch.ceil(n_valid / 2.0), min=1.0)
    take = (torch.arange(n, dtype=costs.dtype, device=costs.device) < k_dyn).to(costs.dtype)
    return torch.einsum("ndhw,n->dhw", srt, take) / k_dyn


def wta_depth(
    cost_volume: torch.Tensor,  # (D, H, W)
    depths: torch.Tensor,  # (D,)
    max_cost: float = 0.4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Winner-take-all depth + parabola sub-hypothesis refinement.

    Returns (depth (H, W), cost (H, W), valid (H, W)). Refinement
    interpolates in INVERSE depth (planes are sampled uniformly there).
    """
    cmin = cost_volume.min(dim=0).values
    d_idx = torch.argmin(cost_volume, dim=0)
    iz, valid_i = refine_inverse(cmin, d_idx, cost_volume, 1.0 / depths, dim=0)
    depth = 1.0 / torch.clamp(iz, min=1e-9)
    return depth, cmin, (cmin <= max_cost) & valid_i


def refine_inverse(cmin, d_idx, cost_volume, inv_levels, dim: int, scale: float = 1.0):
    """Parabola refinement of the WTA winner over the level values
    `inv_levels` (uniform in inverse depth). `scale` divides every cost read
    from the volume (the staged SGM route reads an unnormalised 4-path sum
    and divides by 4 after the read, as the JAX package does). Returns
    (refined level value, interior mask)."""
    dmax = cost_volume.shape[dim] - 1

    def at(idx):
        v = torch.gather(cost_volume, dim, idx.clamp(0, dmax).unsqueeze(dim)).squeeze(dim)
        return v / scale if scale != 1.0 else v

    c0 = at(d_idx - 1)
    c2 = at(d_idx + 1)
    denom = c0 - 2 * cmin + c2
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (c0 - c2) / denom, torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    i0 = inv_levels[(d_idx - 1).clamp(0, dmax)]
    i1 = inv_levels[d_idx]
    i2 = inv_levels[(d_idx + 1).clamp(0, dmax)]
    inv = torch.where(delta >= 0, i1 + delta * (i2 - i1), i1 - delta * (i0 - i1))
    return inv, (d_idx > 0) & (d_idx < dmax)


def make_depth_planes(z_min: float, z_max: float, n: int) -> np.ndarray:
    """Inverse-depth-uniform plane placement (standard plane sweep)."""
    return 1.0 / np.linspace(1.0 / z_max, 1.0 / z_min, n)
