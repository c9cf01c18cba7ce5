"""The comparison that decides `correct`: a set's outputs against the render.

Each check reads what one CLI job wrote into its output directory and
returns the numbers compared, each of which must not exceed its limit
(limits/<cell>.json). The truth is the frozen renderer's (reference/), and
nothing of the program is imported: the outputs are read as files.

sparse (a job from images): the recovered poses of every view and the
  sparse cloud.
  views_missing    views given less views recovered (limit 0)
  ate_pct          sim(3)-aligned RMS camera-centre error, % of the
                   trajectory's extent (the farthest two recovered
                   centres; reference/metrics.py)
  rot_deg          largest error of a relative rotation between two views
  rot_mean_deg     mean error of the relative rotations
  sparse_off_pct   % of sparse points farther than 1% of depth from the
                   surfaces, after the sim(3) of the cameras
  sparse_depth_err_pct  median depth error of the sparse points to the
                   nearest surface, % of its depth
dense (a job resumed from a scene): the fused cloud, the mesh and its
  texture.
  dense_off_pct    % of fused points farther than 1% of depth from the
                   surfaces
  dense_depth_err_pct  median depth error of the fused points, % of depth
  dense_uncovered_pct  % of the true surface samples (every 16th pixel of
                   every view) with no fused point near them
  dense_dup_pct    % of fused points that repeat another's coordinates
                   exactly: a cloud computed or stored in half precision
                   collapses its points onto a coarser grid
  mesh_off_pct     % of mesh vertices farther than 1% of depth
  mesh_dup_pct     % of mesh vertices that repeat another's coordinates
  mesh_empty       1 when the mesh has no face, else 0 (limit 0)
  texture_uncorr_pct  100 (1 - r), r the correlation of the atlas's gray
                   level with the true texture's at the mesh's faces
Each check returns every number it reads; the cell's limits file names
those compared, and the rest are only printed.
"""

from __future__ import annotations

import os

import numpy as np

from h100bench.reference import geometry as G
from h100bench.reference.metrics import trajectory_compare


def _ply_header(f, path: str) -> tuple[list[str], list[tuple[str, int]], int, int]:
    """(header lines, vertex properties (name, bytes), vertices, faces) of
    a binary little-endian PLY whose vertex element starts with float x, y,
    z; `f` is left at the first vertex."""
    head = b""
    while not head.endswith(b"end_header\n"):
        line = f.readline()
        if not line:
            raise ValueError(f"{path}: no end_header")
        head += line
    lines = head.decode("ascii").splitlines()
    if "format binary_little_endian 1.0" not in lines:
        raise ValueError(f"{path}: not binary little-endian")
    sizes = {"float": 4, "float32": 4, "double": 8, "uchar": 1, "uint8": 1, "char": 1,
             "int8": 1, "short": 2, "ushort": 2, "int": 4, "int32": 4, "uint": 4}
    n_vert = n_face = 0
    props, element = [], None
    for ln in lines:
        p = ln.split()
        if p[:1] == ["element"]:
            element = p[1]
            if element == "vertex":
                n_vert = int(p[2])
            elif element == "face":
                n_face = int(p[2])
        elif p[:1] == ["property"] and element == "vertex":
            props.append((p[2], sizes[p[1]]))
    if [n for n, _ in props[:3]] != ["x", "y", "z"] or any(s != 4 for _, s in props[:3]):
        raise ValueError(f"{path}: vertex does not start with float x, y, z")
    return lines, props, n_vert, n_face


def _vertices(f, props, n_vert: int) -> np.ndarray:
    stride = sum(s for _, s in props)
    raw = np.frombuffer(f.read(n_vert * stride), np.uint8).reshape(n_vert, stride)
    return raw[:, :12].copy().view("<f4").reshape(n_vert, 3).astype(np.float64)


def read_ply(path: str) -> tuple[np.ndarray, int]:
    """(vertices (N, 3) float64, faces) of a binary little-endian PLY whose
    vertex element starts with float x, y, z."""
    with open(path, "rb") as f:
        _, props, n_vert, n_face = _ply_header(f, path)
        return _vertices(f, props, n_vert), n_face


TEXTURED_FACE = np.dtype([("n", "u1"), ("v", "<i4", 3), ("m", "u1"), ("uv", "<f4", 6)])


def read_textured_mesh(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(vertices (N, 3), faces (F, 3), texture coordinates (F, 3, 2), atlas
    gray levels (H, W)) of a textured mesh PLY: triangles with a list of
    six float texcoords each (u right, v up), the atlas the image that its
    `comment TextureFile` names beside it."""
    import cv2

    with open(path, "rb") as f:
        lines, props, n_vert, n_face = _ply_header(f, path)
        verts = _vertices(f, props, n_vert)
        faces = np.frombuffer(f.read(n_face * TEXTURED_FACE.itemsize), TEXTURED_FACE)
    names = [ln.split(None, 2)[2] for ln in lines if ln.startswith("comment TextureFile ")]
    if not names or "property list uchar float texcoord" not in lines:
        raise ValueError(f"{path}: no texture")
    if len(faces) != n_face or np.any(faces["n"] != 3) or np.any(faces["m"] != 6):
        raise ValueError(f"{path}: faces are not textured triangles")
    atlas = cv2.imread(os.path.join(os.path.dirname(path), names[0]), cv2.IMREAD_GRAYSCALE)
    if atlas is None:
        raise ValueError(f"{path}: atlas {names[0]} unreadable")
    return verts, faces["v"].astype(np.int64), faces["uv"].reshape(-1, 3, 2), atlas


def bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """img sampled at pixel coordinates (x, y), pixel centres at integers,
    clamped to the image."""
    h, w = img.shape
    x = np.clip(x, 0.0, w - 1.0)
    y = np.clip(y, 0.0, h - 1.0)
    x0 = np.minimum(x.astype(np.int64), w - 2) if w > 1 else np.zeros(len(x), np.int64)
    y0 = np.minimum(y.astype(np.int64), h - 2) if h > 1 else np.zeros(len(y), np.int64)
    fx, fy = x - x0, y - y0
    im = img.astype(np.float64)
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    return (im[y0, x0] * (1 - fx) * (1 - fy) + im[y0, x1] * fx * (1 - fy)
            + im[y1, x0] * (1 - fx) * fy + im[y1, x1] * fx * fy)


def texture_uncorr_pct(verts_gt, faces, uv, atlas, textures) -> float:
    """How far the atlas falls short of following the true texture over the
    mesh's faces: 100 (1 - r), r the correlation of the atlas's gray level
    at each face's centre (its corners' mean texture coordinate) with the
    render's gray level at the face's centre (its corners' mean), over the
    faces whose centre lies on a surface. A correlation at or below 0, or
    none (a flat atlas, no such face): 100."""
    truth = G.surface_gray(verts_gt[faces].mean(1), textures)
    on = np.isfinite(truth)
    if on.sum() < 3:
        return 100.0
    c = uv[on].astype(np.float64).mean(1)
    h, w = atlas.shape
    got = bilinear(atlas, c[:, 0] * w - 0.5, (1.0 - c[:, 1]) * h - 0.5)
    if got.std() == 0 or truth[on].std() == 0:
        return 100.0
    r = float(np.corrcoef(got, truth[on])[0, 1])
    return 100.0 if not r > 0 else 100.0 * (1.0 - r)


def _scene(out: str) -> dict:
    with np.load(os.path.join(out, "scene.npz")) as z:
        return {k: z[k] for k in ("poses", "recovered")}


def _to_truth(out: str, gt_R, gt_C):
    """(recovered views, est_R, est_C, map of scene points into the truth)."""
    sc = _scene(out)
    rec = np.nonzero(sc["recovered"])[0]
    est_R, est_C = G.cameras_of(sc["poses"][rec])
    s, R, t = G.sim3_from_cameras(est_R, est_C, gt_R[rec], gt_C[rec])
    return rec, est_R, est_C, lambda X: s * X @ R.T + t


def check_sparse(out: str, truth: dict) -> dict:
    gt_R, gt_C = truth["R"], truth["C"]
    rec, est_R, est_C, to_truth = _to_truth(out, gt_R, gt_C)
    cmp = trajectory_compare(est_C, est_R, gt_C[rec], gt_R[rec])
    c = gt_C[rec]
    extent = float(np.linalg.norm(c[:, None] - c[None], axis=-1).max())
    pts, _ = read_ply(os.path.join(out, "pointcloud_sparse.ply"))
    return {
        "views_missing": float(len(gt_R) - len(rec)),
        "ate_pct": 100.0 * cmp["ate_rmse"] / extent,
        "rot_deg": float(cmp["max_rel_rot_deg"]),
        "rot_mean_deg": float(cmp["mean_rel_rot_deg"]),
        "sparse_off_pct": G.off_surface_pct(to_truth(pts)),
        "sparse_depth_err_pct": G.depth_err_pct(to_truth(pts)),
    }


def check_dense(out: str, truth: dict) -> dict:
    _, _, _, to_truth = _to_truth(out, truth["R"], truth["C"])
    pts, _ = read_ply(os.path.join(out, "pointcloud_dense.ply"))
    verts, faces, uv, atlas = read_textured_mesh(os.path.join(out, "mesh_dense.ply"))
    dup = G.dup_pct(pts)
    pts = to_truth(pts)
    verts_gt = to_truth(verts)
    return {
        "dense_off_pct": G.off_surface_pct(pts),
        "dense_depth_err_pct": G.depth_err_pct(pts),
        "dense_uncovered_pct": G.uncovered_pct(pts, truth["samples"]),
        "dense_dup_pct": dup,
        "mesh_off_pct": G.off_surface_pct(verts_gt),
        "mesh_dup_pct": G.dup_pct(verts),
        "mesh_empty": float(len(faces) == 0),
        "texture_uncorr_pct": texture_uncorr_pct(verts_gt, faces, uv, atlas, truth["textures"]),
    }


CHECKS = {"sparse": check_sparse, "dense": check_dense}


def truth_of(job: str, gt_R, gt_C, scale: dict, texture_seed: int) -> dict:
    """What the check of `job` compares with: the cameras, and for a dense
    job the true surface samples and the render's textures."""
    truth = {"R": gt_R, "C": gt_C}
    if job == "dense":
        truth["samples"] = G.surface_samples(gt_R, gt_C, scale["width"], scale["height"],
                                             float(scale["f"]))
        truth["textures"] = G.true_textures(texture_seed)
    return truth


def judge(numbers: list[dict], limits: dict) -> tuple[bool, dict]:
    """(every number within its limit in every set, {name: worst value}).
    A set with no numbers (its job failed) fails."""
    if not numbers or any(not n for n in numbers):
        return False, {}
    worst = {k: max(n[k] for n in numbers) for k in limits}
    return all(worst[k] <= limits[k] for k in limits), worst
