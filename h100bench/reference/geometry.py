"""The render's true geometry and the comparisons that judge a reconstruction.

Plain NumPy; imports nothing of the program. `sim3_from_cameras` and the
surface test of `off_surface_pct` are copies of chip_smoke.py's
`sim3_from_cameras` and `surface_share` at commit
c39858ae74ef4e5e9718c7b51256d4a817b4f69c, and `true_textures` and the lookup
of `surface_gray` copy the texture draws and lookup of synth.py (the
program's utils/synth.py) there; `aa_to_rotmat` is Rodrigues'
formula, the convention of the `scene.npz` poses (angle-axis, then t, world
to camera). The surfaces and the cameras are those that synth.py renders:
the z = 10 plane, the z = 7 disc of radius 2 centred at (2, 0), and views
that look along +z from z ~ 0.
"""

from __future__ import annotations

import itertools

import numpy as np

PLANE_Z = 10.0
DISC_Z = 7.0
DISC_CENTRE = (2.0, 0.0)
DISC_RADIUS = 2.0


def aa_to_rotmat(rvec) -> np.ndarray:
    """Rodrigues' formula: (..., 3) angle-axis vectors to (..., 3, 3)."""
    rvec = np.asarray(rvec, np.float64)
    theta = np.linalg.norm(rvec, axis=-1)
    small = theta < 1e-12
    safe = np.where(small, 1.0, theta)
    k = rvec / safe[..., None]
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = np.zeros_like(kx)
    K = np.stack([np.stack([zero, -kz, ky], -1), np.stack([kz, zero, -kx], -1),
                  np.stack([-ky, kx, zero], -1)], -2)
    s = np.where(small, 0.0, np.sin(theta))[..., None, None]
    c = np.where(small, 0.0, 1.0 - np.cos(theta))[..., None, None]
    return np.eye(3) + s * K + c * (K @ K)


def cameras_of(poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(R world to camera (N, 3, 3), centres (N, 3)) of (N, 6) [aa | t] poses."""
    R = aa_to_rotmat(poses[:, :3])
    return R, -np.einsum("sji,sj->si", R, poses[:, 3:])


def sim3_from_cameras(est_R, est_C, gt_R, gt_C):
    """(s, R, t) with X_gt = s R X_est + t. The rotation comes from the
    camera orientations (R = mean of gt_R_i^T est_R_i, projected onto
    SO(3)), scale and translation from the centres by least squares: the
    render's camera centres lie on one line, so centres alone leave the
    roll about that line free."""
    U, _, Vt = np.linalg.svd(np.einsum("sji,sjk->ik", gt_R, est_R))
    R = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    y = est_C @ R.T
    yc, gc = y - y.mean(0), gt_C - gt_C.mean(0)
    s = float((yc * gc).sum() / (yc * yc).sum())
    return s, R, gt_C.mean(0) - s * y.mean(0)


def off_surface_pct(points_gt: np.ndarray, rel: float = 0.01) -> float:
    """Percent of points farther than `rel` of depth from the render's
    surfaces: the z = 10 plane, or the z = 7 disc of radius 2 centred at
    (2, 0), with 1% slack on the radius for rim pixels. The cameras sit at
    z ~ 0 looking along +z, so world z is depth to 1%. No points: 100."""
    if not len(points_gt):
        return 100.0
    x, y, z = np.asarray(points_gt, np.float64).T
    on_plane = np.abs(z - PLANE_Z) <= rel * PLANE_Z
    on_disc = (((x - DISC_CENTRE[0]) ** 2 + (y - DISC_CENTRE[1]) ** 2
                <= (DISC_RADIUS * 1.01) ** 2) & (np.abs(z - DISC_Z) <= rel * DISC_Z))
    return float(100.0 * (1.0 - np.mean(on_plane | on_disc)))


def depth_err_pct(points_gt: np.ndarray) -> float:
    """Median over the points of the depth error to the nearest surface,
    in % of that surface's depth: |z - 10| / 10, or |z - 7| / 7 where the
    point lies over the disc (radius with 1% slack), whichever is less.
    Robust to the few outliers that off_surface_pct counts. No points: 100."""
    if not len(points_gt):
        return 100.0
    x, y, z = np.asarray(points_gt, np.float64).T
    err = np.abs(z - PLANE_Z) / PLANE_Z
    over = (x - DISC_CENTRE[0]) ** 2 + (y - DISC_CENTRE[1]) ** 2 <= (DISC_RADIUS * 1.01) ** 2
    err = np.where(over, np.minimum(err, np.abs(z - DISC_Z) / DISC_Z), err)
    return float(100.0 * np.median(err))


def true_cameras(n_views: int) -> tuple[np.ndarray, np.ndarray]:
    """(R world to camera (V, 3, 3), centres (V, 3)) of the views as
    synth.py places them: a yaw of 0.05 rad a view along a lateral track."""
    ang = (np.arange(n_views) - n_views / 2) * 0.05
    R = aa_to_rotmat(np.stack([np.zeros(n_views), ang, np.zeros(n_views)], -1))
    v = np.arange(n_views, dtype=np.float64)
    return R, np.stack([0.5 * v, 0.03 * v, np.zeros(n_views)], -1)


def surface_samples(gt_R, gt_C, w: int, h: int, f: float, step: int = 16,
                    offset=(0.0, 0.0)) -> np.ndarray:
    """The true surface point seen at every `step`-th pixel of every view,
    moved by `offset` (x, y) pixels, ray-cast as synth.py renders it (the
    disc in front of the plane)."""
    ys, xs = np.meshgrid(np.arange(step // 2, h, step) + offset[1],
                         np.arange(step // 2, w, step) + offset[0], indexing="ij")
    out = []
    for R, C in zip(gt_R, gt_C):
        d = np.stack([(xs - w / 2) / f, (ys - h / 2) / f, np.ones(xs.shape)], -1).reshape(-1, 3) @ R
        on_plane = C + ((PLANE_Z - C[2]) / d[:, 2])[:, None] * d
        on_disc = C + ((DISC_Z - C[2]) / d[:, 2])[:, None] * d
        hit = ((on_disc[:, 0] - DISC_CENTRE[0]) ** 2 + (on_disc[:, 1] - DISC_CENTRE[1]) ** 2
               < DISC_RADIUS ** 2)
        out.append(np.where(hit[:, None], on_disc, on_plane))
    return np.concatenate(out)


PLANE_SCALE = 55.0  # texels a unit of the plane's texture, as synth.py renders it
DISC_SCALE = 75.0


def true_textures(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(plane texture, disc texture), each (1024, 1024) in [0, 1]: the draws
    of synth.py's render_views for a texture seed (no texture_path), copied
    from it at the commit named above."""
    import cv2

    rng = np.random.default_rng(seed)
    tex = cv2.GaussianBlur(rng.random((1024, 1024)).astype(np.float32), (0, 0), 3.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    tex2 = cv2.GaussianBlur(rng.random((1024, 1024)).astype(np.float32), (0, 0), 2.0)
    tex2 = (tex2 - tex2.min()) / (tex2.max() - tex2.min())
    return tex, tex2


def surface_gray(points_gt: np.ndarray, textures, rel: float = 0.01) -> np.ndarray:
    """The render's gray level (0-255) of the surface at each point: the
    disc's texture where the point lies on the disc, the plane's where it
    lies on the plane (within `rel` of depth, as off_surface_pct), NaN where
    it lies on neither. The lookup is synth.py's: the texel under
    (x, y) times the surface's scale, wrapped at 1024."""
    tex, tex2 = textures
    x, y, z = np.asarray(points_gt, np.float64).T
    on_plane = np.abs(z - PLANE_Z) <= rel * PLANE_Z
    on_disc = (((x - DISC_CENTRE[0]) ** 2 + (y - DISC_CENTRE[1]) ** 2
                <= (DISC_RADIUS * 1.01) ** 2) & (np.abs(z - DISC_Z) <= rel * DISC_Z))
    out = np.full(len(x), np.nan)
    for on, t, scale in ((on_plane & ~on_disc, tex, PLANE_SCALE), (on_disc, tex2, DISC_SCALE)):
        u = ((x[on] * scale) % 1024).astype(int) % 1024
        v = ((y[on] * scale) % 1024).astype(int) % 1024
        out[on] = 255.0 * t[v, u]
    return out


def dup_pct(points: np.ndarray) -> float:
    """Percent of the points that repeat an earlier point's coordinates
    exactly. No points: 100."""
    if not len(points):
        return 100.0
    return float(100.0 * (1.0 - len(np.unique(points, axis=0)) / len(points)))


_HALF = 1 << 19  # cells per axis either side of the origin a key can hold


def _keys(cells: np.ndarray) -> np.ndarray:
    c = cells + _HALF
    return (c[:, 0] << 40) | (c[:, 1] << 20) | c[:, 2]


def uncovered_pct(points_gt: np.ndarray, samples: np.ndarray, cell: float = 0.05) -> float:
    """Percent of the true surface samples with no point in the 3 x 3 x 3
    block of `cell`-sized cubes around them (a point within `cell` of a
    sample always counts, one farther than 2 sqrt(3) `cell` never does).
    The default, 0.05, is half of 1% of the plane's depth."""
    pts = np.floor(np.asarray(points_gt, np.float64) / cell)
    pts = pts[np.all(np.abs(pts) < _HALF - 2, axis=1)].astype(np.int64)
    if not len(pts):
        return 100.0
    keys = np.unique(_keys(pts))
    base = np.floor(samples / cell).astype(np.int64)
    covered = np.zeros(len(base), bool)
    for d in itertools.product((-1, 0, 1), repeat=3):
        k = _keys(base + np.asarray(d, np.int64))
        i = np.minimum(np.searchsorted(keys, k), len(keys) - 1)
        covered |= keys[i] == k
    return float(100.0 * (1.0 - covered.mean()))
