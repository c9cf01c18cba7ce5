"""Mesh texturing: per-face view selection + texture atlas + textured PLY.

Replaces openMVS TextureMesh (invoked by the reference when --colored and
--mesh are both set — ref: src/photogrammetrie/mvs/MVS.cpp:175-178,
src/cli/PhotogrammetrieCli.cpp:228) and the textured-PLY writer (ref:
src/photogrammetrie/util/OpenMvsUtils.cpp:312-448: PLY with per-face
`texcoord` lists + `comment TextureFile <png>`).

Batched formulation, in torch on the pipeline's device: all faces are
processed as one batch —
  1. best view per face = argmax over views of (facing cosine) / depth^2
     for faces whose centroid projects inside the view, one (V, F) score,
  2. every face gets one BxB atlas block; its texels are barycentric-
     interpolated to 3D, projected into the face's view and bilinearly
     sampled, in chunks of faces that cap the temporaries,
  3. the atlas assembles by one reshape (blocks are laid out row-major)
     and is read to the host once; the PNG and the PLY are written there.
The sequential chart-packing openMVS does has no batched analogue; uniform
blocks trade some texture space for a fully vectorized fill.

The arithmetic is sfm_mvs_pipeline_tpu/mvs/texture.py's host numpy in
float32: the faces' corners, normals and centroids from the vertices cast
to float32, each view's rotation by Rodrigues in float64 cast to float32.
Where numpy promotes (the bilinear weights, float32 less an int32 corner
index, are float64 there) the port stays in float32, so a texel whose
blend lands next to a half rounds to its neighbour.
"""

from __future__ import annotations

import os

import numpy as np

from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import count

_CHUNK_TEXELS = 4_000_000  # texels sampled at once: caps the temporaries


def _cameras(poses: np.ndarray, dev):
    """Each view's rotation (V, 3, 3), translation (V, 3) and centre (V, 3)
    as float32 tensors on `dev`, computed on the host as numpy does."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np

    R = np.stack([aa_to_rotmat_np(p[:3]).astype(np.float32) for p in poses])
    t = np.asarray(poses, np.float32)[:, 3:6]
    C = np.stack([-R[v].T @ t[v] for v in range(len(poses))])
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (R, t, C))


def select_face_views(corners, R, t, C, intr, image_hw: tuple[int, int]):
    """Best source view per face (int64 tensor, -1 when no view sees the
    face), on the device of `corners` (F, 3, 3) float32.

    Score mirrors openMVS's face-view quality: viewing angle x resolution
    (projected area ~ cos(theta)/z^2), one (V, F) score over every view's
    pinhole projection of the face centroids (images are pre-undistorted)."""
    import torch

    v0, v1, v2 = corners.unbind(1)
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    n = n / torch.sqrt((n * n).sum(1, keepdim=True)).clamp_min(1e-12)
    cent = (v0 + v1 + v2) / 3.0
    h, w = image_hw
    Xc = torch.matmul(cent, R.mT) + t[:, None]  # (V, F, 3)
    z = Xc[..., 2]
    zs = z.clamp_min(1e-6)
    x = Xc[..., 0] / zs * float(intr[0]) + float(intr[1])
    y = Xc[..., 1] / zs * float(intr[0]) + float(intr[2])
    to_cam = C[:, None] - cent
    to_cam = to_cam / torch.sqrt((to_cam * to_cam).sum(-1, keepdim=True)).clamp_min(1e-12)
    cosang = (to_cam * n).sum(-1)
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1) & (z > 1e-6)
    score = torch.where(inside & (cosang > 0.05), cosang / zs**2, -1.0)
    top, best = score.max(0)  # the first of equal scores, as numpy's argmax
    return torch.where(top > 0, best, -1)


def _texel_weights(block: int) -> np.ndarray:
    """Barycentric weights (B*B, 3) float32 of one block's texel grid:
    corners (.5,.5) (B-.5,.5) (.5,B-.5), texels past the diagonal clamped
    back onto the triangle (edge bleed)."""
    ii, jj = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
    l1 = (jj.astype(np.float64)) / (block - 1)  # toward corner 1 (u axis)
    l2 = (ii.astype(np.float64)) / (block - 1)  # toward corner 2 (v axis)
    over = np.maximum(l1 + l2 - 1.0, 0.0) / 2.0
    l1 = np.clip(l1 - over, 0, 1).ravel()
    l2 = np.clip(l2 - over, 0, 1).ravel()
    l0 = np.clip(1.0 - l1 - l2, 0, 1)
    return np.stack([l0, l1, l2], axis=1).astype(np.float32)


def _sample(L, corners, best, R, t, images, intr):
    """The (Fc, B*B, 3) uint8 texels of a chunk of faces: each texel's
    point (weights @ corners) projected into its face's view and bilinearly
    sampled from that view's image, rounded half to even; 128 where the
    face has no view."""
    import torch

    nv, vh, vw = images.shape[:3]
    v = best.clamp_min(0)
    p = torch.matmul(L, corners)  # (Fc, B*B, 3)
    Xc = torch.matmul(p, R[v].mT) + t[v][:, None]
    z = Xc[..., 2].clamp_min(1e-9)
    # images are undistorted; intr distortion terms are zero here
    x = (Xc[..., 0] / z * float(intr[0]) + float(intr[1])).clamp(0.0, vw - 1.0)
    y = (Xc[..., 1] / z * float(intr[0]) + float(intr[2])).clamp(0.0, vh - 1.0)
    x0 = x.to(torch.int32).clamp_max(vw - 2)
    y0 = y.to(torch.int32).clamp_max(vh - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = images.view(nv * vh * vw, 3)
    i00 = (v[:, None] * vh + y0) * vw + x0
    s = flat[i00] * ((1 - fx) * (1 - fy))
    s += flat[i00 + 1] * (fx * (1 - fy))
    s += flat[i00 + vw] * ((1 - fx) * fy)
    s += flat[i00 + vw + 1] * (fx * fy)
    texels = s.round().clamp(0, 255).to(torch.uint8)
    return torch.where(best[:, None, None] >= 0, texels, 128)


def build_texture_atlas(
    vertices: np.ndarray,
    faces: np.ndarray,
    poses: np.ndarray,
    intr: np.ndarray,
    images: np.ndarray,  # (V, H, W, 3) uint8 (undistorted)
    block: int = 8,
    device=None,
) -> dict:
    """Returns {"atlas": (A, A, 3) uint8, "uv": (F, 3, 2) float in [0, 1],
    "face_view": (F,) int32}, numpy arrays; the view selection, sampling
    and assembly run on `device` (default: the card; raises without one),
    with one host read of the atlas and the face views. Counts the faces
    in "texture faces", and in "texture device faces" on a card."""
    import torch

    from sfm_mvs_pipeline_tpu_torch import resolve_device

    dev = resolve_device(device)
    nf = len(faces)
    vh, vw = images.shape[1:3]
    count("texture faces", nf)
    if dev.type == "cuda":
        count("texture device faces", nf)

    cols = max(1, int(np.ceil(np.sqrt(max(nf, 1)))))
    rows = max(1, -(-nf // cols))
    aw, ah = cols * block, rows * block

    V = torch.as_tensor(np.asarray(vertices, np.float32), device=dev)
    F = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    corners = V[F]  # (F, 3, 3)
    R, t, C = _cameras(poses, dev)
    imgs = torch.as_tensor(np.ascontiguousarray(images, np.uint8), device=dev)
    best = select_face_views(corners, R, t, C, intr, (vh, vw))

    L = torch.as_tensor(_texel_weights(block), device=dev)
    blocks = torch.full((rows * cols, block * block, 3), 128, dtype=torch.uint8, device=dev)
    chunk = max(1, _CHUNK_TEXELS // (block * block))
    for c0 in range(0, nf, chunk):
        c1 = min(c0 + chunk, nf)
        blocks[c0:c1] = _sample(L, corners[c0:c1], best[c0:c1], R, t, imgs, intr)
    # assemble: blocks row-major, read to the host once
    atlas = (
        blocks.view(rows, cols, block, block, 3)
        .permute(0, 2, 1, 3, 4)
        .reshape(ah, aw, 3)
        .cpu()
        .numpy()
    )
    face_view = best.to(torch.int32).cpu().numpy()

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
    return {"atlas": atlas, "uv": uv_out.astype(np.float32), "face_view": face_view}


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
