"""BENCHMARK.json and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own under h100bench/:

  configs/<config>.json   the flag set and image set of a deployment (the
                          `file` that BENCHMARK.json gives the config)
  traffic/<traffic>.json  the job a cell times ("sparse" or "dense")
  limits/<cell>.json      the limits of the numbers that decide `correct`
  metrics/<metric>.py     a reader: read(ctx) -> float or None; metrics
                          that split one quantity by cells or job kind
                          share metrics/<quantity>.py (Bench.reader_path)

so a later cell or metric is added as new files and entries, without an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os

HOME = "h100bench"


class Bench:
    """BENCHMARK.json at `root`, with lookups of its cells' files."""

    def __init__(self, root: str):
        self.root = root
        self.home = os.path.join(root, HOME)
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}

    def _json(self, *parts: str) -> dict:
        with open(os.path.join(self.home, *parts)) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root, self.configs[name]["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json("limits", f"{cell}.json")["limits"]

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer ones (on):
        each that lists the cell under `workloads`, or has no such key and
        moves (or is) an end-to-end metric the cell reports."""
        e2e = [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]

    def reader_path(self, metric: str) -> str | None:
        """The reader of `metric`: metrics/<metric>.py, or where there is none
        the one that a quantity split by cells (`<quantity>.<cells>`) or by
        job kind (`<kind>_<quantity>`) shares, metrics/<quantity>.py."""
        for name in (metric, metric.split(".", 1)[0], metric.split("_", 1)[-1]):
            path = os.path.join(self.home, "metrics", f"{name}.py")
            if os.path.exists(path):
                return path
        return None

    def reader(self, metric: str):
        """The read(ctx) of `metric`'s reader."""
        path = self.reader_path(metric)
        if path is None:
            raise FileNotFoundError(f"no reader of {metric!r} under {self.home}/metrics")
        spec = importlib.util.spec_from_file_location(f"{HOME}_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
