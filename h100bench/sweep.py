"""The time of one sparse job on each of a list of texture seeds, in one
process, forward and then backward: how much the SfM's work follows the
images (PERF.md; the texture list of traffic/sparse-1080p.json).

    python3 h100bench/sweep.py --config unordered-sift-bf --textures 3000000201,3000000202

The first job runs twice (the first pays the process's cold start). Each
line gives the job's wall time, its stage times, and the bundle
adjustments and their LM iterations that its log reports.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import jobs  # noqa: E402
from h100bench.inputs import image_set  # noqa: E402
from h100bench.manifest import Bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--textures", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    config = bench.config(args.config)
    textures = [int(t) for t in args.textures.split(",")]
    work = tempfile.mkdtemp(prefix="h100bench-sweep-")
    for i, texture in enumerate([textures[0]] + textures + textures[::-1]):
        images, _, _ = image_set(bench.home, config["images"], texture)
        out = os.path.join(work, f"job{i}")
        argv = jobs.argv_of("sparse", config, out, images, None, args.device) + ["--stage-times"]
        rc, wall = jobs.run_cli(argv, out + ".log", args.device)
        log = open(out + ".log", errors="replace").read()
        ba = re.findall(r"BA #(\d+): .*\((\d+) iters", log)
        stages = re.findall(r"stage times: (.*)", log)
        print(json.dumps({"job": i, "texture": texture, "rc": rc, "wall_s": wall,
                          "ba_runs": len(ba), "ba_iters": sum(int(x[1]) for x in ba),
                          "stages": stages[-1][:300] if stages else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
