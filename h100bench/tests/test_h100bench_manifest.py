"""BENCHMARK.json against the contract the harness relies on, and a cell
added as new files alone."""

import hashlib
import json
import os
import re
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench.manifest import Bench  # noqa: E402

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def problems(bench: Bench) -> list[str]:
    """What in BENCHMARK.json breaks the names and cross-references the
    harness relies on, and which named file is missing."""
    spec, out = bench.spec, []
    metrics = spec["end_to_end"] + spec["per_layer"]
    named = ([("config", c["name"]) for c in spec["configs"]]
             + [("cell", w["name"]) for w in spec["workloads"]]
             + [("metric", m["name"]) for m in metrics]
             + [("traffic", w["traffic"]) for w in spec["workloads"]]
             + [("reduced key", k) for c in spec["configs"] for k in c["reduced"]])
    out += [f"{kind} {n!r}: bad name" for kind, n in named if not NAME.fullmatch(n)]
    for kind, group in (("config", spec["configs"]), ("cell", spec["workloads"]),
                        ("metric", metrics)):
        seen = [x["name"] for x in group]
        out += [f"{kind} {n!r} twice" for n in set(seen) if seen.count(n) > 1]
    out += [f"metric {m['name']!r}: bad unit {m['unit']!r}" for m in metrics
            if not UNIT.fullmatch(m["unit"])]
    out += [f"metric {m['name']!r}: better {m['better']!r}" for m in metrics
            if m["better"] not in ("lower", "higher")]
    out += [f"metric {m['name']!r}: source {m['source']!r}" for m in metrics
            if m["source"] not in SOURCES]
    out += [f"end-to-end {m['name']!r}: source {m['source']!r}" for m in spec["end_to_end"]
            if m["source"] not in ("host_clock", "device_trace")]
    if "setup_s" not in {m["name"] for m in spec["end_to_end"]}:
        out.append("no setup_s")
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    out += [f"cell of {p} twice" for p in set(pairs) if pairs.count(p) > 1]
    for w in spec["workloads"]:
        cell = w["name"]
        if w["config"] not in bench.configs:
            out.append(f"cell {cell!r}: no config {w['config']!r}")
        e2e = {m["name"] for m in bench.metrics(cell, False)}
        layer = bench.metrics(cell, True)
        if "setup_s" not in e2e or len(e2e) < 2:
            out.append(f"cell {cell!r}: end-to-end metrics {sorted(e2e)}")
        if not layer:
            out.append(f"cell {cell!r}: no per-layer metric")
        files = [("traffic", f"{w['traffic']}.json"), ("limits", f"{cell}.json")]
        out += [f"cell {cell!r}: no {os.path.join(*f)}" for f in files
                if not os.path.exists(os.path.join(bench.home, *f))]
    e2e_names = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        if m["moves"] not in e2e_names:
            out.append(f"metric {m['name']!r} moves unknown {m['moves']!r}")
        for cell in m.get("workloads", []):
            if cell not in bench.cells:
                out.append(f"metric {m['name']!r}: unknown cell {cell!r}")
            elif m["moves"] not in {x["name"] for x in bench.metrics(cell, False)}:
                out.append(f"metric {m['name']!r}: cell {cell!r} does not report {m['moves']!r}")
    for m in metrics:
        if bench.reader_path(m["name"]) is None:
            out.append(f"metric {m['name']!r}: no reader")
    for c in spec["configs"]:
        if not os.path.exists(os.path.join(bench.root, c["file"])):
            out.append(f"config {c['name']!r}: no file {c['file']!r}")
    return out


def _spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_has_no_problems():
    assert problems(Bench(ROOT)) == []


def test_keys_are_exactly_the_contract_s():
    spec = _spec()
    assert set(spec) == TOP
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in spec["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in spec["workloads"])
    base = {"name", "unit", "better", "source"}
    assert all(set(m) - {"workloads"} == base | {"bound"} for m in spec["end_to_end"])
    assert all(set(m) == base | {"layer", "moves", "workloads"} for m in spec["per_layer"])


def test_names_units_and_bounds():
    spec = _spec()
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = ([x["name"] for x in spec["configs"] + spec["workloads"] + metrics]
             + [w["traffic"] for w in spec["workloads"]]
             + [k for c in spec["configs"] for k in c["reduced"]])
    assert all(NAME.fullmatch(n) for n in names), names
    assert all(UNIT.fullmatch(m["unit"]) for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in spec["end_to_end"])
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert spec["command"][1].startswith(spec["paths"][0] + "/")
    assert all(w["chips"] == 1 for w in spec["workloads"])
    for text in [c["why"] for c in spec["configs"] + spec["workloads"]] + [
            c["source"] for c in spec["configs"]] + [m["layer"] for m in spec["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_per_layer_metric_s_cells_report_the_metric_it_moves():
    bench = Bench(ROOT)
    for m in bench.spec["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in bench.metrics(cell, False)}
            assert m in bench.metrics(cell, True)
    for cell in bench.cells:
        names = {e["name"] for e in bench.metrics(cell, False)}
        assert "setup_s" in names and len(names) >= 2
        assert bench.metrics(cell, True)


def test_every_config_file_states_its_cut_and_scale():
    bench = Bench(ROOT)
    for entry in bench.spec["configs"]:
        cfg = bench.config(entry["name"])
        assert cfg["name"] == entry["name"]
        assert set(cfg["reduced"]) == set(entry["reduced"])
        assert {"views", "width", "height", "f"} <= set(cfg["images"])
        assert set(cfg["dense_flags"]) <= set(cfg["flags"]) and cfg["assumed"]


def _digest(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "h100bench")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_config_traffic_and_metric_are_added_as_files_alone(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "h100bench"), os.path.join(root, "h100bench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = _digest(root)
    home = os.path.join(root, "h100bench")
    base = json.load(open(os.path.join(home, "configs", "unordered-sift-bf.json")))
    base.update(name="sequence-sift", flags=base["flags"] + ["-Pfeature-sequence=3"])
    with open(os.path.join(home, "configs", "sequence-sift.json"), "w") as f:
        json.dump(base, f)
    with open(os.path.join(home, "traffic", "sparse-4k.json"), "w") as f:
        json.dump({"job": "sparse"}, f)
    with open(os.path.join(home, "limits", "sequence-sift.sparse-4k.json"), "w") as f:
        json.dump({"limits": {"views_missing": 0}}, f)
    with open(os.path.join(home, "metrics", "sets_done.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['sets'])\n")
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "sequence-sift", "source": "a later PR's source",
                            "file": "h100bench/configs/sequence-sift.json",
                            "reduced": ["artifacts"], "why": "a later PR's configuration"})
    spec["workloads"].append({"name": "sequence-sift.sparse-4k", "config": "sequence-sift",
                              "traffic": "sparse-4k", "chips": 1, "why": "a later PR's cell"})
    spec["end_to_end"][0]["workloads"].append("sequence-sift.sparse-4k")
    spec["per_layer"].append({"name": "sets_done", "unit": "sets", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "sparse_s_per_set",
                              "workloads": ["sequence-sift.sparse-4k"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    bench = Bench(root)
    assert problems(bench) == []
    cell = "sequence-sift.sparse-4k"
    assert bench.config("sequence-sift")["flags"][-1] == "-Pfeature-sequence=3"
    assert bench.traffic("sparse-4k")["job"] == "sparse"
    assert bench.limits(cell) == {"views_missing": 0}
    assert [m["name"] for m in bench.metrics(cell, False)] == ["sparse_s_per_set", "setup_s"]
    assert [m["name"] for m in bench.metrics(cell, True)] == ["sets_done"]
    assert bench.reader("sets_done")({"sets": 4}) == 4.0
    after = _digest(root)
    assert {k: after[k] for k in before} == before  # no file that was there changed
