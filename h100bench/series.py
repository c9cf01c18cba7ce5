"""Runs of the benchmark back to back, each a process of its own, and the
spread of each metric over a series: what the bounds in BENCHMARK.json
are set from (PERF.md).

    python3 h100bench/series.py --out chiprun_out/series --seconds 51 \
        A:unordered-sift-bf.sparse-1080p:1,2,3,4,5,6 \
        B:unordered-sift-bf.sparse-1080p:1,2,3,4,5,6 \
        T:unordered-sift-bf.sparse-1080p:7,8,9:trace

Each argument is a series: a label, a cell, its seeds, and `trace` for
--trace 1 runs. Every run's standard output and error are kept under
--out; one line a run is printed as it ends, and last, for each series of
untraced runs, each metric's median and spread (the distance between the
first and third quartiles of statistics.quantiles over the median), with
and without the run farthest from the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values: list[float]) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def without_farthest(values: list[float]) -> list[float]:
    m = statistics.median(values)
    k = max(range(len(values)), key=lambda j: abs(values[j] - m))
    return values[:k] + values[k + 1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("series", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    got: dict[str, list[dict]] = {}
    for spec in args.series:
        label, cell, seeds, *rest = spec.split(":")
        trace = int(rest == ["trace"])
        for seed in seeds.split(","):
            base = os.path.join(args.out, f"{label}.{cell}.{seed}.{trace}")
            t0 = time.time()
            with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
                rc = subprocess.call([sys.executable, os.path.join(HERE, "run.py"),
                                      "--workload", cell, "--seed", seed, "--seconds",
                                      str(args.seconds), "--trace", str(trace)],
                                     stdout=out, stderr=err)
            lines = open(base + ".out").read().strip().splitlines()
            result = json.loads(lines[-1]) if rc == 0 and lines else {}
            got.setdefault(label, []).append(result)
            sets = [ln for ln in open(base + ".err") if ln.startswith(("set-up ", "sets: "))]
            print(json.dumps({"series": label, "cell": cell, "seed": int(seed), "trace": trace,
                              "rc": rc, "took_s": round(time.time() - t0, 1),
                              "correct": result.get("correct"),
                              "metrics": {k: m["value"] for k, m in
                                          result.get("metrics", {}).items()},
                              "memory_peak_bytes": result.get("device", {}).get(
                                  "memory_peak_bytes"),
                              "busy_s": result.get("device", {}).get("busy_s"),
                              "window_s": result.get("device", {}).get("window_s"),
                              "checks": {k: c["value"] for k, c in
                                         result.get("checks", {}).items()},
                              "log": [ln.strip()[:300] for ln in sets]}), flush=True)
    for label, results in got.items():
        ok = [r for r in results if r.get("metrics")]
        names = sorted({k for r in ok for k in r["metrics"]})
        for name in names:
            values = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
            if len(values) < 3:
                continue
            print(json.dumps({"series": label, "metric": name, "runs": len(values),
                              "median": statistics.median(values), "spread": spread(values),
                              "spread_without_farthest": spread(without_farthest(values))
                              if len(values) > 3 else None, "values": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
