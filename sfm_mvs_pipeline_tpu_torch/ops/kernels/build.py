"""Build the port's CUDA sources into shared libraries with nvcc.

Route (b) of the port's kernel rule: each source under
sfm_mvs_pipeline_tpu_torch/csrc/ has a plain C interface and is compiled
with nvcc for sm_90a into sfm_mvs_pipeline_tpu_torch/build/, named by a hash
of the source and flags so an edit rebuilds, then loaded with ctypes by its
wrapper. Nothing is built when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
REPORTS: dict[str, str] = {}  # source -> the ptxas -v report of its last verbose build
_LOCK = threading.RLock()
_LOADED: dict = {}


def load(key, loader):
    """loader()'s result, made once a key under the lock (a library built
    and its entry points typed once, whichever thread asks first)."""
    if key not in _LOADED:
        with _LOCK:
            if key not in _LOADED:
                _LOADED[key] = loader()
    return _LOADED[key]


def reset_launches(*wrappers) -> None:
    """Zero each wrapper's launch counts: `launches` (the total) and
    `by_card` ({card index: launches})."""
    with _LOCK:
        for fn in wrappers:
            fn.launches = 0
            fn.by_card = {}


def count_launch(fn, device) -> None:
    """One launch of wrapper fn's kernel on `device`'s card."""
    with _LOCK:
        fn.launches += 1
        fn.by_card[device.index] = fn.by_card.get(device.index, 0) + 1


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    cands.append(shutil.which("nvcc") or "")
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(source: str) -> str:
    """Hash-named library path of one source under csrc/."""
    with open(os.path.join(CSRC, source), "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{os.path.splitext(source)[0]}_{tag}.so")


def build(*sources: str, verbose: bool = False) -> list[str]:
    """Compile the sources whose libraries are missing, one nvcc process
    each, all started together. Returns the library paths; `verbose` adds
    `-Xptxas -v`, rebuilds, prints each compiler report and keeps it in
    REPORTS."""
    with _LOCK:
        return _build(sources, verbose)


def _build(sources, verbose: bool) -> list[str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = [library_path(s) for s in sources]
    jobs = []
    for source, path in zip(sources, paths):
        if os.path.exists(path) and not verbose:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC, source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((source, path, tmp, proc))
    errors = []
    for source, path, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {source} ({proc.returncode}):\n{err}")
            continue
        if verbose:
            REPORTS[source] = err
            print(f"{source}:\n{err.strip()}", flush=True)
        os.replace(tmp, path)  # atomic: concurrent builders never see a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths
