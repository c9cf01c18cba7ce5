"""Mesh texturing: per-face view selection + texture atlas + textured PLY.

Replaces openMVS TextureMesh (invoked by the reference when --colored and
--mesh are both set — ref: src/photogrammetrie/mvs/MVS.cpp:175-178,
src/cli/PhotogrammetrieCli.cpp:228) and the textured-PLY writer (ref:
src/photogrammetrie/util/OpenMvsUtils.cpp:312-448: PLY with per-face
`texcoord` lists + `comment TextureFile <png>`).

Batched formulation: all faces are processed as one batch —
  1. best view per face = argmax over views of (facing cosine) / depth^2
     for faces whose centroid projects inside the view,
  2. every face gets one BxB atlas block; its texel grid is barycentric-
     interpolated to 3D in a single (F, B*B, 3) array, projected and
     bilinearly sampled per view group,
  3. the atlas assembles by one reshape (blocks are laid out row-major).
The sequential chart-packing openMVS does has no batched analogue; uniform
blocks trade some texture space for a fully vectorized fill.

Copy of sfm_mvs_pipeline_tpu/mvs/texture.py: host numpy in both packages.
"""

from __future__ import annotations

import os

import numpy as np


def _face_geometry(vertices: np.ndarray, faces: np.ndarray):
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    centroid = (v0 + v1 + v2) / 3.0
    return n, centroid


def select_face_views(
    vertices: np.ndarray,
    faces: np.ndarray,
    poses: np.ndarray,  # (V, 6)
    intr: np.ndarray,  # (7,)
    image_hw: tuple[int, int],
) -> np.ndarray:
    """Best source view per face (int, -1 when no view sees the face).

    Score mirrors openMVS's face-view quality: viewing angle x resolution
    (projected area ~ cos(theta)/z^2). Host numpy: per-view pinhole
    projection of face centroids (images are pre-undistorted)."""
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np

    normals, centroids = _face_geometry(vertices, faces)
    h, w = image_hw
    nf = len(faces)
    score = np.full((len(poses), nf), -1.0, np.float32)
    cent32 = centroids.astype(np.float32)
    for v in range(len(poses)):
        R = aa_to_rotmat_np(poses[v][:3]).astype(np.float32)
        t = poses[v][3:6].astype(np.float32)
        Xc = cent32 @ R.T + t
        z = Xc[:, 2]
        zs = np.maximum(z, 1e-6)
        x = Xc[:, 0] / zs * intr[0] + intr[1]
        y = Xc[:, 1] / zs * intr[0] + intr[2]
        C = -R.T @ t  # camera center
        to_cam = C[None] - cent32
        to_cam /= np.maximum(
            np.linalg.norm(to_cam, axis=-1, keepdims=True), 1e-12
        )
        cosang = np.einsum("fk,fk->f", to_cam, normals.astype(np.float32))
        inside = (
            (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1) & (z > 1e-6)
        )
        score[v] = np.where(
            inside & (cosang > 0.05), cosang / zs**2, -1.0
        )
    best = score.argmax(0)
    best[score.max(0) <= 0] = -1
    return best.astype(np.int32)


def build_texture_atlas(
    vertices: np.ndarray,
    faces: np.ndarray,
    poses: np.ndarray,
    intr: np.ndarray,
    images: np.ndarray,  # (V, H, W, 3) uint8 (undistorted)
    block: int = 8,
) -> dict:
    """Returns {"atlas": (A, A, 3) uint8, "uv": (F, 3, 2) float in [0, 1]}."""
    nf = len(faces)
    vh, vw = images.shape[1:3]
    best = select_face_views(vertices, faces, poses, intr, (vh, vw))

    cols = max(1, int(np.ceil(np.sqrt(max(nf, 1)))))
    rows = max(1, -(-nf // cols))
    aw, ah = cols * block, rows * block

    # barycentric texel grid of one block: corners (.5,.5) (B-.5,.5) (.5,B-.5)
    ii, jj = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
    l1 = (jj.astype(np.float64)) / (block - 1)  # toward corner 1 (u axis)
    l2 = (ii.astype(np.float64)) / (block - 1)  # toward corner 2 (v axis)
    # clamp texels past the diagonal back onto the triangle (edge bleed)
    over = np.maximum(l1 + l2 - 1.0, 0.0) / 2.0
    l1 = np.clip(l1 - over, 0, 1).ravel()
    l2 = np.clip(l2 - over, 0, 1).ravel()
    l0 = np.clip(1.0 - l1 - l2, 0, 1)

    # Host-numpy sampling: pure projection + bilinear gather. Texel
    # positions are produced per CHUNK of faces with a batched f32 matmul
    # (barycentric weights @ face corners), which caps peak temp memory.
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np

    L = np.stack([l0, l1, l2], axis=1).astype(np.float32)  # (B*B, 3)
    corners = np.stack(
        [vertices[faces[:, i]] for i in range(3)], axis=1
    ).astype(np.float32)  # (F, 3, 3)
    texels = np.full((nf, block * block, 3), 128, np.uint8)
    chunk_faces = max(1, 4_000_000 // (block * block))
    for v in np.unique(best):
        if v < 0:
            continue
        sel = np.nonzero(best == v)[0]
        R = aa_to_rotmat_np(poses[v][:3]).astype(np.float32)
        t = poses[v][3:6].astype(np.float32)
        img = images[v]
        for c0 in range(0, len(sel), chunk_faces):
            sc = sel[c0 : c0 + chunk_faces]
            # (Fc, B*B, 3) texel positions, one BLAS batch matmul
            p = (L @ corners[sc]).reshape(-1, 3)
            Xc = p @ R.T + t
            z = np.maximum(Xc[:, 2], 1e-9)
            # images are undistorted; intr distortion terms are zero here
            x = np.clip(Xc[:, 0] / z * intr[0] + intr[1], 0.0, vw - 1.0)
            y = np.clip(Xc[:, 1] / z * intr[0] + intr[2], 0.0, vh - 1.0)
            x0 = np.minimum(x.astype(np.int32), vw - 2)
            y0 = np.minimum(y.astype(np.int32), vh - 2)
            fx = (x - x0)[:, None]
            fy = (y - y0)[:, None]
            s = img[y0, x0] * ((1 - fx) * (1 - fy))
            s += img[y0, x0 + 1] * (fx * (1 - fy))
            s += img[y0 + 1, x0] * ((1 - fx) * fy)
            s += img[y0 + 1, x0 + 1] * (fx * fy)
            texels[sc] = np.clip(np.round(s), 0, 255).astype(
                np.uint8
            ).reshape(len(sc), block * block, 3)

    # assemble: pad to rows*cols blocks, reshape row-major
    pad = rows * cols - nf
    blocks = np.concatenate(
        [texels.reshape(nf, block, block, 3),
         np.full((pad, block, block, 3), 128, np.uint8)]
    )
    atlas = (
        blocks.reshape(rows, cols, block, block, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(ah, aw, 3)
    )

    # per-face-corner texcoords (u right, v up — flipped y like openMVS)
    bi = np.arange(nf)
    x0 = (bi % cols) * block
    y0 = (bi // cols) * block
    corners_px = np.stack(
        [
            np.stack([x0 + 0.5, y0 + 0.5], 1),
            np.stack([x0 + block - 0.5, y0 + 0.5], 1),
            np.stack([x0 + 0.5, y0 + block - 0.5], 1),
        ],
        axis=1,
    )  # (F, 3, 2) pixel coords in atlas
    uv_out = np.empty_like(corners_px, dtype=np.float64)
    uv_out[..., 0] = corners_px[..., 0] / aw
    uv_out[..., 1] = 1.0 - corners_px[..., 1] / ah
    return {"atlas": atlas, "uv": uv_out.astype(np.float32), "face_view": best}


def write_ply_mesh_textured(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    uv: np.ndarray,  # (F, 3, 2)
    atlas: np.ndarray,  # (A, A, 3) uint8
    colors: np.ndarray | None = None,
) -> None:
    """Textured-mesh PLY: TextureFile comment + per-face texcoord lists
    (the format the reference emits — OpenMvsUtils.cpp:312-448). The atlas
    PNG is written next to the PLY."""
    import cv2

    tex_name = os.path.splitext(os.path.basename(path))[0] + ".png"
    cv2.imwrite(
        os.path.join(os.path.dirname(path) or ".", tex_name),
        atlas[..., ::-1],  # RGB -> BGR
    )
    v = len(vertices)
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"comment TextureFile {tex_name}",
        f"element vertex {v}",
        "property float x",
        "property float y",
        "property float z",
    ]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        header += [
            "property uchar red", "property uchar green", "property uchar blue",
        ]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    header += [
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "property list uchar float texcoord",
        "end_header",
    ]
    rec = np.empty(v, dtype=fields)
    rec["x"], rec["y"], rec["z"] = (
        vertices[:, i].astype(np.float32) for i in range(3)
    )
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = (
            colors[:, i].astype(np.uint8) for i in range(3)
        )
    ftype = [("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4"),
             ("m", "u1")] + [(f"t{i}", "<f4") for i in range(6)]
    frec = np.empty(len(faces), dtype=ftype)
    frec["n"] = 3
    frec["a"], frec["b"], frec["c"] = (
        faces[:, i].astype(np.int32) for i in range(3)
    )
    frec["m"] = 6
    flat = uv.reshape(len(faces), 6)
    for i in range(6):
        frec[f"t{i}"] = flat[:, i].astype(np.float32)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        rec.tofile(f)
        frec.tofile(f)
