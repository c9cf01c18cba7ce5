"""Run one cell of the port's benchmark once, and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds sfm_mvs_pipeline_tpu_torch beside
BENCHMARK.json. The cell (BENCHMARK.json `workloads`) names a
configuration (a run script's flags and an image set, configs/) and a
traffic mix (the job it times, traffic/). One run:

1. set-up: renders the image sets (reference/synth.py; kept in
   h100bench/.cache/inputs/; the textures from --seed, or those the
   traffic mix lists in an order drawn from --seed, inputs.py), makes the
   scene a dense job resumes from (a sparse job with the configuration's
   flags), and warms with one job of the timed kind. `setup_s` runs from
   the process's start to here.
2. the window: units of work back to back, a unit one job on each image
   set of the run, each job one CLI call
   (sfm_mvs_pipeline_tpu_torch.cli.app.main) writing a fresh output
   directory under $TMPDIR. A unit starts while the window's clock reads
   under --seconds; the one running when it passes is finished and
   counted. The time per set is the window's length over the sets.
   With --trace 1 the program's stage timers and a torch.profiler capture
   of the card's activity run too, and the per-layer metrics are printed
   in place of the end-to-end ones.
3. the check: every set's outputs against the render's truth (checks.py),
   each number against limits/<cell>.json.

The last line of standard output is the result as one JSON object; the
numbers compared, each with its limit, are the last lines of standard
error. Without a card, with fewer cards than the cell asks for, without
the port beside it, or with jax, jaxlib, flax or sfm_mvs_pipeline_tpu
loaded once the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import checks, jobs, trace  # noqa: E402
from h100bench.inputs import image_set, unit_of, warm_texture  # noqa: E402
from h100bench.manifest import Bench  # noqa: E402

# compared by whole top-level names: the port's own name begins with the last
FORBIDDEN = ("jax", "jaxlib", "flax", "sfm_mvs_pipeline_tpu")
DEVICE = "cuda:0"


def forbidden_modules() -> list[str]:
    """The forbidden top-level packages in sys.modules."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def process_start() -> float:
    """The wall-clock time (s since the epoch) this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def window(job, seconds: float, clock=time.perf_counter) -> tuple[int, float]:
    """Run job(i) for i = 0, 1, ... while the clock, read before each,
    is under `seconds` from the start (the first always runs); the one
    running when it passes is finished. Returns (jobs run, seconds from the
    first start to the last finish). A job here is a unit of work."""
    t0 = clock()
    n = 0
    while n == 0 or clock() - t0 < seconds:
        job(n)
        n += 1
    return n, clock() - t0


def _bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


class SetupFailed(RuntimeError):
    pass


def run_cell(root: str, name: str, seed: int, seconds: float, trace_on: bool,
             device: str = DEVICE, t_start: float | None = None, say=None,
             warm: bool = True) -> dict:
    """One run of cell `name`; returns the result object (see module doc).
    warm=False leaves out the set-up's warm job (readings of the check
    alone, not a run of the benchmark)."""
    t_start = time.time() if t_start is None else t_start
    say = say or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = Bench(root)
    cell = bench.cells[name]
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    kind = traffic["job"]
    limits = bench.limits(name)
    cuda = device.startswith("cuda")
    spans: list = []
    if trace_on:
        from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

        spans = trace.record_spans(stage_timer)
    import torch

    work = tempfile.mkdtemp(prefix="h100bench-")
    try:
        unit = unit_of(traffic, seed)
        sets = {t: image_set(bench.home, config["images"], t)
                for t in dict.fromkeys(unit + [warm_texture(traffic, seed)])}
        t_inputs = time.time()

        def job(label: str, job_kind: str, texture: int,
                scene: str | None = None) -> tuple[int, float, str, int]:
            out = os.path.join(work, label)
            argv = jobs.argv_of(job_kind, config, out, sets[texture][0], scene, device)
            rc, wall = jobs.run_cli(argv, out + ".log", device)
            return rc, wall, out, texture

        def setup_job(label: str, job_kind: str, texture: int, scene: str | None = None) -> str:
            rc, wall, out, _ = job(label, job_kind, texture, scene)
            say(f"set-up {label}: {job_kind} job, rc {rc}, {wall:.3f} s")
            if rc != 0:
                raise SetupFailed(f"set-up {label} exited {rc}:\n" + jobs.log_tail(out + ".log"))
            return out

        scene = None
        if kind == "dense":  # a dense unit is one image set: the scene is its
            scene = os.path.join(setup_job("scene", "sparse", unit[0]), "scene.npz")
        if warm:
            shutil.rmtree(setup_job("warm", kind, warm_texture(traffic, seed), scene),
                          ignore_errors=True)
        if cuda:
            torch.cuda.synchronize(torch.device(device))
        setup_s = time.time() - t_start
        say(f"set-up {setup_s:.3f} s (inputs ready at {t_inputs - t_start:.3f} s)")

        runs: list[tuple[int, float, str, int]] = []
        capture: dict = {"events": []}
        with contextlib.ExitStack() as stack:
            if trace_on:
                stage_timer.enable()
                if cuda:
                    stack.enter_context(trace.device_capture(capture))
            lo = time.time_ns()
            units, window_s = window(lambda i: runs.extend(
                job(f"set-{i}-{j}", kind, t, scene) for j, t in enumerate(unit)), seconds)
            hi = time.time_ns()
        stages = {}
        if trace_on:
            stages = {k: v[0] for k, v in stage_timer.report().items()}
            stage_timer.enable(False)
        n = len(runs)
        say("sets: " + ", ".join(f"rc {rc} {wall:.3f} s" for rc, wall, _, _ in runs)
            + f"; {units} units of {len(unit)}; window {window_s:.3f} s; "
            + f"outputs {sum(_bytes(o) for _, _, o, _ in runs)} bytes")
        peak = int(torch.cuda.max_memory_allocated(torch.device(device))) if cuda else 0

        truths = {t: checks.truth_of(kind, sets[t][1], sets[t][2], config["images"], t)
                  for t in unit}
        numbers = []
        for rc, _, out, t in runs:
            try:
                numbers.append(checks.CHECKS[kind](out, truths[t]) if rc == 0 else {})
            except (OSError, ValueError, KeyError) as e:
                say(f"check of {out}: {type(e).__name__}: {e}")
                numbers.append({})
            if rc != 0:
                say(f"{out} exited {rc}:\n" + jobs.log_tail(out + ".log"))
        correct, worst = checks.judge(numbers, limits)
        for k in sorted({k for x in numbers for k in x} - set(limits)):
            say(f"read, not compared: {k} {max(x[k] for x in numbers if x)}")
        failed = sum(1 for x in numbers if not x or any(x[k] > limits[k] for k in limits))

        events = capture["events"]
        ctx = {"config": config, "kind": kind, "sets": n,
               "window_s": window_s, "setup_s": setup_s, "stages": stages, "events": events,
               "lo": lo, "hi": hi, "outputs": [out for rc, _, out, _ in runs if rc == 0]}
        metrics = {}
        for m in bench.metrics(name, trace_on):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu",
               "count": cell["chips"], "memory_peak_bytes": peak}
        result = {"correct": bool(correct), "attempted": n, "failed": failed,
                  "metrics": metrics, "device": dev}
        if trace_on:
            dev["busy_s"] = trace.busy_s(events, lo, hi)
            dev["window_s"] = (hi - lo) / 1e9
            if events:
                say(f"device events {len(events)}: first starts {(events[0][1] - lo) / 1e6:.3f} ms "
                    f"after the window opens, last ends {(hi - max(e[2] for e in events)) / 1e6:.3f}"
                    f" ms before it closes")
            result["breakdown"] = {"device_ops": trace.by_name(events)[:10],
                                   "idle_gaps": trace.idle_gaps(events, spans, lo, hi)}
        result["sets"] = [{"texture": t, "rc": rc, "wall_s": wall, "numbers": x}
                          for (rc, wall, _, t), x in zip(runs, numbers)]
        result["checks"] = {k: {"value": worst.get(k), "limit": v} for k, v in limits.items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = Bench(ROOT)
        chips = bench.cells[args.workload]["chips"]
    except (OSError, KeyError, ValueError) as e:
        print(f"no cell {args.workload!r} in {ROOT}: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cell {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    try:
        import sfm_mvs_pipeline_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 2
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except SetupFailed as e:
        print(str(e), file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
        return 3
    try:
        with open("/proc/self/io") as f:
            wrote = next(int(ln.split()[1]) for ln in f if ln.startswith("wchar"))
        print(f"bytes this process passed to write calls: {wrote}", file=sys.stderr)
    except (OSError, StopIteration):
        pass
    for i, one in enumerate(result.pop("sets")):
        print(f"set {i}: {json.dumps(one)}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
