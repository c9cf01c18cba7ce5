"""The control of a cell's comparison: the reference, put in the program's
place and computed in the nearest precision below the one its configuration
states, has to come out not correct.

    python3 h100bench/control.py --workload <cell> --seeds 1,2,3 [--dtype bfloat16]

The reference's answers are the render's own: the true poses (angle-axis
and translation, world to camera, as scene.npz keeps them), as the clouds
the true surface points that the views' pixels see (every 16th pixel for
the sparse cloud, every 2nd for the dense cloud, at sub-pixel offsets
drawn from the seed), and as the mesh the true surface points at every
16th pixel of each view, joined into triangles along the view's pixel
grid, each triangle textured with the render's gray level at its centre.
They are computed in `dtype` on the card (on the CPU where there is none),
written as the program writes its outputs, and judged by the cell's own
check (checks.py) against its limits. The default precision is the one
below the outputs' float32, bfloat16, for both cells (the dense cell's
bfloat16 SGM costs are a stage inside the program, not an output). The
texture seed is the seed itself, as a dense cell draws its textures. The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import checks  # noqa: E402
from h100bench.manifest import Bench  # noqa: E402
from h100bench.reference import geometry as G  # noqa: E402

BELOW = {"sparse": "bfloat16", "dense": "bfloat16"}


def _write_ply(path: str, xyz: np.ndarray) -> None:
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {len(xyz)}",
            "property float x", "property float y", "property float z", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        f.write(np.ascontiguousarray(xyz, "<f4").tobytes())


def _write_textured_mesh(path: str, xyz: np.ndarray, faces: np.ndarray, gray: np.ndarray) -> None:
    """A textured mesh PLY as the program writes one: an atlas of one texel
    a face (gray level `gray`), each face's texture coordinates placed
    around its texel's centre."""
    import cv2

    side = max(1, int(np.ceil(np.sqrt(len(faces)))))
    atlas = np.full(side * side, 128, np.uint8)
    atlas[:len(faces)] = gray
    cv2.imwrite(os.path.join(os.path.dirname(path), "mesh_dense.png"), atlas.reshape(side, side))
    i = np.arange(len(faces))
    cx, cy = i % side + 0.5, i // side + 0.5  # texel centres, pixels
    corner = np.array([[0.0, -0.3], [-0.26, 0.15], [0.26, 0.15]])  # mean 0
    uv = np.empty((len(faces), 3, 2), np.float32)
    uv[..., 0] = (cx[:, None] + corner[:, 0]) / side
    uv[..., 1] = 1.0 - (cy[:, None] + corner[:, 1]) / side
    rec = np.empty(len(faces), checks.TEXTURED_FACE)
    rec["n"], rec["v"], rec["m"], rec["uv"] = 3, faces, 6, uv.reshape(-1, 6)
    head = ["ply", "format binary_little_endian 1.0", "comment TextureFile mesh_dense.png",
            f"element vertex {len(xyz)}", "property float x", "property float y",
            "property float z", f"element face {len(faces)}",
            "property list uchar int vertex_indices", "property list uchar float texcoord",
            "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        f.write(np.ascontiguousarray(xyz, "<f4").tobytes())
        f.write(rec.tobytes())


def _grid_faces(rows: int, cols: int, views: int) -> np.ndarray:
    """Two triangles a cell of each view's rows x cols sample grid, the
    samples numbered view by view, row-major (surface_samples' order)."""
    r, c = np.meshgrid(np.arange(rows - 1), np.arange(cols - 1), indexing="ij")
    a = (r * cols + c).ravel()
    one = np.concatenate([np.stack([a, a + 1, a + cols], 1),
                          np.stack([a + 1, a + cols + 1, a + cols], 1)])
    return np.concatenate([one + v * rows * cols for v in range(views)])


def reference_outputs(out: str, scale: dict, seed: int, kind: str, dtype: str,
                      device: str) -> None:
    """Write the reference's answers, computed in `dtype`, into `out` as a
    `kind` job of the program would."""
    import torch

    dt = getattr(torch, dtype)

    def low(x):  # one rounding to the lower precision, as a result stored in it
        return torch.as_tensor(x, device=device).to(dt).to(torch.float64)

    V, w, h, f = scale["views"], scale["width"], scale["height"], float(scale["f"])
    v = torch.arange(V, dtype=torch.float64, device=device)
    ang = low((v - V / 2) * 0.05)
    c, s = low(torch.cos(ang)), low(torch.sin(ang))
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, zero, s], -1), torch.stack([zero, one, zero], -1),
                     torch.stack([-s, zero, c], -1)], -2)
    C = torch.stack([low(0.5 * v), low(0.03 * v), zero], -1)
    t = low(-(R @ C[..., None])[..., 0])
    poses = torch.cat([torch.stack([zero, ang, zero], -1), t], -1).cpu().numpy()
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, "scene.npz"), poses=poses, recovered=np.ones(V, bool))
    gt_R, gt_C = G.true_cameras(V)
    offset = np.random.default_rng(seed % 2**64).uniform(-0.5, 0.5, 2)
    pts = G.surface_samples(gt_R, gt_C, w, h, f, 16 if kind == "sparse" else 2, offset)
    pts = low(pts).cpu().numpy()
    if kind == "sparse":
        _write_ply(os.path.join(out, "pointcloud_sparse.ply"), pts)
        return
    _write_ply(os.path.join(out, "pointcloud_dense.ply"), pts)
    verts = G.surface_samples(gt_R, gt_C, w, h, f, 16, offset)
    faces = _grid_faces(len(range(8, h, 16)), len(range(8, w, 16)), V)
    gray = G.surface_gray(verts[faces].mean(1), G.true_textures(seed % 2**64))
    gray = low(np.nan_to_num(gray, nan=128.0) / 255.0).cpu().numpy() * 255.0
    _write_textured_mesh(os.path.join(out, "mesh_dense.ply"), low(verts).cpu().numpy(),
                         faces, np.clip(np.round(gray), 0, 255).astype(np.uint8))


def control_readings(root: str, cell: str, seeds: list[int], dtype: str | None,
                     device: str) -> list[dict]:
    """The cell's numbers for the reference computed in `dtype` (default:
    the precision below the configuration's), one dict a seed."""
    bench = Bench(root)
    spec = bench.cells[cell]
    config = bench.config(spec["config"])
    kind = bench.traffic(spec["traffic"])["job"]
    dtype = dtype or BELOW[kind]
    scale = config["images"]
    gt_R, gt_C = G.true_cameras(scale["views"])
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            d = os.path.join(tmp, str(seed))
            reference_outputs(d, scale, seed, kind, dtype, device)
            truth = checks.truth_of(kind, gt_R, gt_C, scale, seed % 2**64)
            out.append(checks.CHECKS[kind](d, truth))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default=None)
    args = ap.parse_args(argv)
    import torch

    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    bench = Bench(ROOT)
    limits = bench.limits(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, numbers in zip(seeds, control_readings(ROOT, args.workload, seeds, args.dtype,
                                                     device)):
        fails = sorted(k for k in limits if numbers[k] > limits[k])
        print(json.dumps({"workload": args.workload, "seed": seed, "dtype": args.dtype or "default",
                          "device": device, "numbers": numbers, "fails": fails}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
