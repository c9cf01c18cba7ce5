"""The port's rectified PatchMatch, as one dense job of the PatchMatch cell
runs it, against the plain reference (plain_pm.py) on the card.

    python3 h100bench/pm_check.py --workload grid-sift-flann-pm.dense-pm-1080p --texture 7 --view 5

It makes the cell's scene (one sparse job) and runs one dense job on it
(jobs.run_cli, in this process), keeping the inputs that the program's
`_patchmatch_view` was given for one view: its undistorted images, poses,
neighbours, depth range and disparity bound. Then, on the same uniform
draws (drawn on the card, one set a neighbour), it runs the program's
`patchmatch_rect_depth` (K3 on the card) and the reference's on that view
with all its neighbours, three ways: the reference with its own window
statistics, with the program's (`stats=`: bit-equal where every other step
rounds alike), and with its scoring in bfloat16 (the control, which has to
fail the comparison). It prints one JSON line: each comparison
(plain_pm.py::compare at 1% and at 1e-4 relative), the seconds each side
took, and the job's check numbers. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import checks, jobs  # noqa: E402
from h100bench import plain_pm as ref_pm  # noqa: E402
from h100bench.inputs import image_set  # noqa: E402
from h100bench.manifest import Bench  # noqa: E402

PORT = "sfm_mvs_pipeline_tpu_torch"


def _timed(fn, cuda: bool):
    import torch

    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--texture", type=int, required=True)
    ap.add_argument("--view", type=int, default=5, help="index among the recovered views")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    import importlib

    import numpy as np
    import torch

    pipeline = importlib.import_module(f"{PORT}.mvs.pipeline")
    patchmatch = importlib.import_module(f"{PORT}.mvs.patchmatch")
    plane_sweep = importlib.import_module(f"{PORT}.mvs.plane_sweep")

    bench = Bench(ROOT)
    cell = bench.cells[args.workload]
    config = bench.config(cell["config"])
    images, gt_R, gt_C = image_set(bench.home, config["images"], args.texture % 2**64)
    kept = {}
    inner = pipeline._patchmatch_view

    def keep(cfg, i, nbrs, grays_d, poses, poses_d, intr_d, focal, z_lo, z_hi, w):
        if i == args.view:
            kept.update(cfg=cfg, nbrs=list(nbrs), grays=grays_d, poses=poses, poses_d=poses_d,
                        intr=intr_d, focal=focal, z_lo=float(z_lo), z_hi=float(z_hi), w=w)
        return inner(cfg, i, nbrs, grays_d, poses, poses_d, intr_d, focal, z_lo, z_hi, w)

    work = tempfile.mkdtemp(prefix="pm-check-")
    pipeline._patchmatch_view = keep
    try:
        scene_out = os.path.join(work, "scene")
        rc, _ = jobs.run_cli(jobs.argv_of("sparse", config, scene_out, images, None, args.device),
                             scene_out + ".log", args.device)
        if rc:
            raise SystemExit(f"sparse job exited {rc}:\n" + jobs.log_tail(scene_out + ".log"))
        out = os.path.join(work, "dense")
        rc, wall = jobs.run_cli(jobs.argv_of("dense", config, out, images,
                                             os.path.join(scene_out, "scene.npz"), args.device),
                                out + ".log", args.device)
        if rc:
            raise SystemExit(f"dense job exited {rc}:\n" + jobs.log_tail(out + ".log"))
        truth = checks.truth_of("dense", gt_R, gt_C, config["images"], args.texture % 2**64)
        numbers = checks.check_dense(out, truth)
    finally:
        pipeline._patchmatch_view = inner
        shutil.rmtree(work, ignore_errors=True)
    if not kept:
        raise SystemExit(f"view {args.view} took no PatchMatch")

    from sfm_mvs_pipeline_tpu_torch.mvs.rectified import derive_max_disp, rect_geometry_ok

    cfg, i, nbrs = kept["cfg"], args.view, kept["nbrs"]
    cap = cfg.n_neighbors
    nb = (nbrs + [nbrs[0]] * cap)[:cap]
    ok = rect_geometry_ok(kept["poses"][i], kept["poses"][nb]) & (np.arange(cap) < len(nbrs))
    md = derive_max_disp(kept["poses"][i], kept["poses"][nb], kept["focal"], kept["z_lo"],
                         kept["w"])
    grays = kept["grays"]
    h, w = grays.shape[1:]
    cuda = grays.device.type == "cuda"
    gen = torch.Generator(device=grays.device).manual_seed(args.texture % 2**63)
    it = cfg.pm_iterations

    def rand():
        return torch.rand((h, w), generator=gen, device=grays.device)

    draws = [(rand(), [(rand(), rand()) for _ in range(2 * it)]) for _ in range(cap)]
    common = dict(iterations=it, window_radius=cfg.window_radius, max_cost=cfg.max_cost,
                  max_disp=md, nbr_valid=ok)
    view = (grays[i], grays[nb], kept["poses_d"][i], kept["poses_d"][nb], kept["intr"],
            kept["z_lo"], kept["z_hi"])
    port, port_s = _timed(lambda: patchmatch.patchmatch_rect_depth(*view, draws=draws, **common),
                          cuda)
    ways = {"own stats": {}, "program's stats": {"stats": plane_sweep.window_stats},
            "bfloat16 scoring": {"score_dtype": torch.bfloat16}}
    result = {"workload": args.workload, "texture": args.texture, "view": i,
              "neighbours": nb, "usable": ok.tolist(), "max_disp": md,
              "depth_range": [kept["z_lo"], kept["z_hi"]], "shape": [h, w], "iterations": it,
              "device": torch.cuda.get_device_name(grays.device) if cuda else "cpu",
              "program_s": port_s, "job_s": wall, "numbers": numbers}
    for name, extra in ways.items():
        plain, plain_s = _timed(lambda: ref_pm.patchmatch_rect_depth(*view, draws, **common,
                                                                     **extra), cuda)
        result[name] = {"at_1pct": ref_pm.compare(port[0], port[2], plain[0], plain[2], 1e-2),
                        "at_1e-4": ref_pm.compare(port[0], port[2], plain[0], plain[2], 1e-4),
                        "plain_s": plain_s}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
