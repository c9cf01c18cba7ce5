"""Where a sparse job's depth error comes from: its sparse points against
the render's surfaces as the job placed them, and triangulated anew from
the job's own tracks with the render's true cameras.

    python3 h100bench/retriangulate.py --workload unordered-orb-bf.sparse-1080p --textures 3000000202,17

For each texture it runs one sparse job of the cell's configuration
(jobs.run_cli, in this process) and reads its scene.npz. Every valid point
is triangulated again (linear, in normalised coordinates) from the raw
keypoints of its live observations, with the render's poses and focal
length and no distortion: its depth error then holds only the keypoints'
own error. The job's check numbers (checks.check_sparse, the cell's
yardstick) sit beside the same two numbers of the new points, the median
reprojection error of the observations under the true cameras, and the
job's estimated focal length and radial terms. Where the new points lie on
the surfaces and the job's do not, the error is in the job's cameras; where
both are off alike, it is in the keypoints. The benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import checks, jobs  # noqa: E402
from h100bench.inputs import image_set  # noqa: E402
from h100bench.manifest import Bench  # noqa: E402
from h100bench.reference import geometry as G  # noqa: E402


def triangulate(scene, gt_R: np.ndarray, gt_C: np.ndarray, w: int, h: int,
                f: float) -> tuple[np.ndarray, np.ndarray]:
    """(points (P, 3), reprojection error px of each observation used) of
    the scene's valid points with two or more live observations, from the
    raw keypoints under the true cameras (the render's pixel convention: a
    pixel's centre at its integer coordinates, the principal point at
    (w / 2, h / 2))."""
    live = (scene["obs_w"] > 0) & scene["point_valid"][scene["obs_point"]]
    pt, shot, feat = (scene[k][live].astype(np.int64) for k in ("obs_point", "obs_shot", "obs_feat"))
    uv = scene["keypoints"][shot, feat].astype(np.float64)
    xn = np.stack([(uv[:, 0] - w / 2) / f, (uv[:, 1] - h / 2) / f], -1)
    P = np.concatenate([gt_R, -(gt_R @ gt_C[..., None])], -1)[shot]  # (O, 3, 4)
    rows = np.stack([xn[:, :1] * P[:, 2] - P[:, 0], xn[:, 1:] * P[:, 2] - P[:, 1]], 1)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    ids, pt = np.unique(pt, return_inverse=True)
    A = np.zeros((len(ids), 4, 4))
    np.add.at(A, pt, np.einsum("oij,oik->ojk", rows, rows))
    enough = np.bincount(pt, minlength=len(ids)) >= 2
    X = np.linalg.eigh(A)[1][:, :, 0]
    X = X[:, :3] / X[:, 3:]
    cam = np.einsum("oij,oj->oi", P, np.concatenate([X[pt], np.ones((len(pt), 1))], -1))
    err = f * np.linalg.norm(cam[:, :2] / cam[:, 2:] - xn, axis=-1)
    return X[enough], err[enough[pt]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--textures", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    config = bench.config(bench.cells[args.workload]["config"])
    scale = config["images"]
    w, h, f = scale["width"], scale["height"], float(scale["f"])
    work = tempfile.mkdtemp(prefix="h100bench-retri-")
    try:
        for texture in (int(t) for t in args.textures.split(",")):
            images, gt_R, gt_C = image_set(bench.home, scale, texture)
            out = os.path.join(work, str(texture))
            argv_job = jobs.argv_of("sparse", config, out, images, None, args.device)
            rc, wall = jobs.run_cli(argv_job, out + ".log", args.device)
            if rc != 0:
                print(json.dumps({"workload": args.workload, "texture": texture, "rc": rc}))
                continue
            scene = dict(np.load(os.path.join(out, "scene.npz")))
            X, err = triangulate(scene, gt_R, gt_C, w, h, f)
            intr = scene["intrinsics"][0]
            print(json.dumps({
                "workload": args.workload, "texture": texture, "rc": rc, "job_s": wall,
                "job": checks.check_sparse(out, {"R": gt_R, "C": gt_C}),
                "true_cameras": {"points": len(X), "sparse_off_pct": G.off_surface_pct(X),
                                 "sparse_depth_err_pct": G.depth_err_pct(X),
                                 "reproj_px_median": float(np.median(err)),
                                 "reproj_px_p90": float(np.quantile(err, 0.9))},
                "f_est": float(intr[0]), "f_true": f, "f_err_pct": 100.0 * (intr[0] / f - 1.0),
                "k1": float(intr[3]), "k2": float(intr[4])}), flush=True)
            shutil.rmtree(out, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
