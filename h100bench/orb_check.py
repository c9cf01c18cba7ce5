"""The port's ORB front end and Hamming 2-NN, as one sparse job of a cell
runs them, against the plain reference (plain_orb.py) on the card.

    python3 h100bench/orb_check.py --workload unordered-orb-bf.sparse-1080p --texture 3000000202

It runs one sparse job of the cell's configuration on one image set
(jobs.run_cli, in this process), keeping what the program's
`ops.orb.orb_features` and `ops.matching.match_pairs_batch` returned in
it; then computes the reference's ORB on the same images at the same
capacity, and the reference's 2-NN and ratio test on the program's own
descriptors over the configuration's pair table, and compares them with
the tolerances the CPU tests use (plain_orb.py::compare,
compare_matches). It prints one JSON line: the counts, the failures, the
job's check numbers and the seconds each side took. The benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import importlib
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
from h100bench.inputs import image_set  # noqa: E402
from h100bench.manifest import Bench  # noqa: E402
from h100bench import plain_orb as ref_orb  # noqa: E402
from h100bench.reference.pairs import pairs_of  # noqa: E402

PORT = "sfm_mvs_pipeline_tpu_torch"


def _kept(module, name: str, into: dict):
    """Wrap module.name so its first call's result lands in into[name]."""
    inner = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = inner(*args, **kwargs)
        into.setdefault(name, out)
        return out

    setattr(module, name, wrapper)
    return inner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--texture", type=int, required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    import cv2
    import numpy as np
    import torch

    bench = Bench(ROOT)
    config = bench.config(bench.cells[args.workload]["config"])
    images, gt_R, gt_C = image_set(bench.home, config["images"], args.texture)
    orb_mod = importlib.import_module(f"{PORT}.ops.orb")
    match_mod = importlib.import_module(f"{PORT}.ops.matching")
    got: dict = {}
    inner_orb = _kept(orb_mod, "orb_features", got)
    inner_match = _kept(match_mod, "match_pairs_batch", got)
    work = tempfile.mkdtemp(prefix="h100bench-orb-")
    try:
        out = os.path.join(work, "job")
        argv_job = jobs.argv_of("sparse", config, out, images, None, args.device)
        rc, wall = jobs.run_cli(argv_job, out + ".log", args.device)
        numbers = checks.check_sparse(out, {"R": gt_R, "C": gt_C}) if rc == 0 else {}
    finally:
        orb_mod.orb_features, match_mod.match_pairs_batch = inner_orb, inner_match
        shutil.rmtree(work, ignore_errors=True)
    port = {k: v.cpu() for k, v in got["orb_features"].items()}
    best, mask = (x.cpu() for x in got["match_pairs_batch"][:2])
    capacity = port["valid"].shape[1]
    names = sorted(n for n in os.listdir(images) if n.lower().endswith((".png", ".jpg")))
    imgs = np.stack([cv2.imread(os.path.join(images, n), cv2.IMREAD_GRAYSCALE) for n in names])
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t1 = time.perf_counter()
    ref = ref_orb.orb(torch.from_numpy(imgs.astype(np.float32) / 255.0).to(dev), capacity)
    sync()
    t_orb = time.perf_counter() - t1
    features = ref_orb.compare(port, ref)
    pairs = pairs_of(config["flags"], len(imgs))
    desc = ref_orb.expand(port["descriptors"].to(dev))
    t2 = time.perf_counter()
    nn = ref_orb.two_nn(desc, port["valid"].to(dev), pairs)
    sync()
    t_nn = time.perf_counter() - t2
    vq = port["valid"][torch.as_tensor(pairs[:, 0]).long()]
    matches = ref_orb.compare_matches(best, mask, nn, vq)
    dist = got["match_pairs_batch"][2].cpu()
    matches["counts"]["best_sq_differ"] = int(
        (torch.round(dist * dist)[vq] != nn["best_sq"].cpu()[vq]).sum())
    ok = not features["fails"] and not matches["fails"] and not matches["counts"]["best_sq_differ"]
    print(json.dumps({
        "workload": args.workload, "texture": args.texture, "device": args.device,
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "rc": rc, "job_s": wall,
        "capacity": capacity, "views": len(imgs), "pairs": len(pairs),
        "valid_per_view": port["valid"].sum(1).tolist(),
        "features": features, "matches": matches, "check": numbers,
        "reference_orb_s": t_orb, "reference_2nn_s": t_nn,
        "correct": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
