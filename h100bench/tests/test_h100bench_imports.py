"""What the benchmark's command loads: never jax, jaxlib, flax or the JAX
package (sfm_mvs_pipeline_tpu), compared by whole top-level names since the
port's own name begins with the JAX package's; and a reference that loads
nothing of the program."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import run  # noqa: E402

HOME = os.path.join(ROOT, "h100bench")


def _python(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("sfm_mvs_pipeline_tpu_torch.cli", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sfm_mvs_pipeline_tpu.utils", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax", "sfm_mvs_pipeline_tpu"]


def test_every_module_the_command_can_import_leaves_jax_out():
    """The harness's modules, each metric reader, and every module of the
    port (the CLI imports its modules lazily, so all of them)."""
    code = f"""
import importlib, json, os, pkgutil, sys
sys.path.insert(0, {ROOT!r})
import h100bench.run, h100bench.control
from h100bench.manifest import Bench
bench = Bench({ROOT!r})
for m in bench.spec["end_to_end"] + bench.spec["per_layer"]:
    bench.reader(m["name"])
import sfm_mvs_pipeline_tpu_torch as port
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
print(json.dumps(h100bench.run.forbidden_modules()))
"""
    done = _python(code)
    assert done.returncode == 0, done.stderr
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
import h100bench.reference.geometry, h100bench.reference.metrics, h100bench.reference.pairs
import h100bench.reference.roofline, h100bench.reference.synth
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    done = _python(code)
    assert done.returncode == 0, done.stderr
    loaded = set(json.loads(done.stdout.strip().splitlines()[-1]))
    assert not loaded & {"sfm_mvs_pipeline_tpu_torch", "sfm_mvs_pipeline_tpu", "jax", "torch"}
    ref = os.path.join(HOME, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                    for a in n.names}
            tops |= {n.module.split(".")[0] for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.module}
            assert tops <= {"__future__", "itertools", "numpy", "os", "cv2"}, (name, tops)


def test_without_a_card_it_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                           "unordered-sift-bf.sparse-1080p", "--seed", "3000000000",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode != 0 and done.stdout == ""
    assert "CUDA card" in done.stderr


def test_an_unknown_cell_prints_no_result():
    done = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "no.such-cell",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode != 0 and done.stdout == ""
