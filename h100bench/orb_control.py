"""The control of the ORB cell's comparison: the plain reference's ORB
(plain_orb.py) computed in bfloat16, put in the place of the program's ORB
front end in the cell's own job, has to come out not correct.

    python3 h100bench/orb_control.py --workload unordered-orb-bf.sparse-1080p --seeds 1,2

control.py puts the render's own answers in the program's place; in this
cell they read, in bfloat16, under ORB's own pose error, so no limit lies
between the two. This control keeps the whole job (the CLI's sparse job as
the cell times it: pair pose, PnP, bundle adjustment, the outputs) and
computes in bfloat16 only what the configuration states in float32 and this
configuration alone runs: the ORB front end, every float step of it (the
pyramid, FAST, Harris, keypoints, orientation, the BRIEF comparisons),
through plain_orb.py's `dtype`. Its results are widened back to float32 as
the program hands them on. For each seed it runs one unit of the cell (every
image set of the run; faults.reading) and prints one JSON line with every
set's numbers, the worst of each, and the limits they pass. The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import faults  # noqa: E402
from h100bench import plain_orb  # noqa: E402
from h100bench.manifest import Bench  # noqa: E402

PORT = "sfm_mvs_pipeline_tpu_torch"


def reference_orb(dtype):
    """An `orb_features` that computes plain_orb.orb in `dtype` and widens its
    floating results to float32."""
    import torch

    def orb_features(images, max_features=2048, **kwargs):
        out = plain_orb.orb(images, max_features, dtype)
        return {k: v.to(torch.float32) if v.is_floating_point() else v for k, v in out.items()}

    return orb_features


@contextlib.contextmanager
def front_end_in(dtype):
    """The program with its ORB front end replaced by the reference in `dtype`."""
    mod = importlib.import_module(f"{PORT}.ops.orb")
    inner = mod.orb_features
    mod.orb_features = reference_orb(dtype)
    try:
        yield
    finally:
        mod.orb_features = inner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="unordered-orb-bf.sparse-1080p")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    import torch

    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    limits = Bench(ROOT).limits(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        with front_end_in(getattr(torch, args.dtype)):
            out = faults.reading(ROOT, args.workload, seed, device)
        fails = sorted(k for k, v in out["checks"].items() if v is None or v > limits[k])
        print(json.dumps({"workload": args.workload, "seed": seed, "dtype": args.dtype,
                          "device": device, **out, "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
