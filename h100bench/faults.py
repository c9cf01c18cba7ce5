"""Readings of a cell's check at its own size, sound and with the timed path
broken: what its limits are set from (limits/<cell>.json, PERF.md).

    python3 h100bench/faults.py --workload <cell> --seeds 1,2,3 [--runs all|sound|<fault>,...]

For each seed it runs the cell once in this process (run.run_cell with a
window of 0 s and no warm job: one unit of work, every image set of the
run) for each of --runs: `sound`, or a fault (FAULTS) planted in the
program; `all` is sound and then every fault of the cell. It prints one
JSON line a run with every set's numbers and the cell's verdict.
The faults are those the cell can have on one chip (no exchange between
chips to leave out): a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced. The benchmark's
runs never run this; tests/test_h100bench_faults.py plants the same faults
at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SPARSE = "unordered-sift-bf.sparse-1080p"
DENSE = "grid-sift-flann-sgm.dense-1080p"
PORT = "sfm_mvs_pipeline_tpu_torch"


def _ba_returns_its_state(inner, views):
    def ba(points, poses, intr, *args, **kwargs):
        return {"points": points, "poses": poses, "intrinsics": intr, "cost": 0.0,
                "iterations": 0, "converged": True, "lambda": 0.0, "table_kind": "track"}
    return ba


def _half_images_blank(inner, views):
    def load(paths, *args, **kwargs):
        imgs, size = inner(paths, *args, **kwargs)
        imgs = np.array(imgs, copy=True)
        imgs[len(imgs) // 2:] = 0
        return imgs, size
    return load


def _last_pose_moved(inner, views):
    def save(scene, path):
        last = np.nonzero(scene.recovered)[0][-1]
        scene.poses[last, 3] += 0.1 * np.abs(scene.poses[scene.recovered, 3:]).max()
        return inner(scene, path)
    return save


def _sgm_returns_its_costs(inner, views):  # the plain route: costs normalised
    return lambda cost, *args, **kwargs: cost


def _staged_sgm_returns_its_costs(inner, views):  # K2b's route: the 4-path sum
    return lambda cost, *args, **kwargs: 4.0 * cost


def _half_depth_maps_empty(inner, views):
    def view(cfg, i, *args, **kwargs):
        depth, valid, tag = inner(cfg, i, *args, **kwargs)
        return depth, (valid & False) if i >= views // 2 else valid, tag
    return view


def _fused_points_scaled(inner, views):
    def fuse(*args, **kwargs):
        out = inner(*args, **kwargs)
        out["points"] = out["points"] * 1.03
        return out
    return fuse


def _atlas_blank(inner, views):
    def build(*args, **kwargs):
        out = inner(*args, **kwargs)
        out["atlas"] = np.full_like(out["atlas"], 128)
        return out
    return build


# cell -> fault -> [(module of the port, attribute, make(inner, views) -> replacement)]
FAULTS = {
    SPARSE: {
        "bundle adjustment returns its state unchanged":
            [(f"{PORT}.sfm.incremental", "run_bundle_adjustment", _ba_returns_its_state)],
        "half of the image batch left out (blank)":
            [(f"{PORT}.utils.images", "load_gray_batch", _half_images_blank)],
        "a pose altered where it is written":
            [(f"{PORT}.utils.checkpoint", "save_scene", _last_pose_moved)],
    },
    DENSE: {
        "SGM aggregation returns its costs unchanged":
            [(f"{PORT}.mvs.sgm", "sgm_aggregate", _sgm_returns_its_costs),
             (f"{PORT}.ops.kernels.sgm_kernel", "sgm_staged_hwd", _staged_sgm_returns_its_costs)],
        "half of the views' depth maps left out":
            [(f"{PORT}.mvs.pipeline", "depth_map_view", _half_depth_maps_empty)],
        "the fused points altered where they are made":
            [(f"{PORT}.mvs.fusion", "fuse_depth_maps", _fused_points_scaled)],
        "the texture atlas left blank":
            [(f"{PORT}.mvs.texture", "build_texture_atlas", _atlas_blank)],
    },
}


@contextlib.contextmanager
def planted(cell: str, fault: str, views: int):
    """The program with `fault` of `cell` planted, for the block's length."""
    done = []
    try:
        for module, name, make in FAULTS[cell][fault]:
            mod = importlib.import_module(module)
            inner = getattr(mod, name)
            setattr(mod, name, make(inner, views))
            done.append((mod, name, inner))
        yield
    finally:
        for mod, name, inner in reversed(done):
            setattr(mod, name, inner)


def reading(root: str, cell: str, seed: int, device: str) -> dict:
    """One unit of the cell on `seed`: its verdict and every set's numbers."""
    from h100bench.run import run_cell

    r = run_cell(root, cell, seed, 0, False, device=device, say=lambda msg: None, warm=False)
    return {"correct": r["correct"], "sets": r["sets"],
            "checks": {k: c["value"] for k, c in r["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--runs", default="all", help="all, or sound and fault names joined by commas")
    args = ap.parse_args(argv)
    import torch

    from h100bench.manifest import Bench

    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    bench = Bench(ROOT)
    views = bench.config(bench.cells[args.workload]["config"])["images"]["views"]
    runs = ["sound", *FAULTS[args.workload]] if args.runs == "all" else args.runs.split(",")
    unknown = set(runs) - {"sound", *FAULTS[args.workload]}
    if unknown:
        ap.error(f"no such fault of {args.workload}: {sorted(unknown)}")
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in runs:
            sound = fault == "sound"
            with contextlib.nullcontext() if sound else planted(args.workload, fault, views):
                try:
                    out = reading(ROOT, args.workload, seed, device)
                except Exception as e:  # a fault may crash the job's set-up
                    out = {"correct": False, "error": f"{type(e).__name__}: {str(e)[-300:]}"}
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault,
                              "device": device, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
