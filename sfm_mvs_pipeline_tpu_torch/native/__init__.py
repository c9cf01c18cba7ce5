"""Native (C++) host tier, loaded via ctypes.

A copy of the JAX package's sfm_mvs_pipeline_tpu/native (the port imports
nothing of that package). The reference implements its host-side runtime in
C++ (PCL kd-tree kNN, binary PLY writers — ref:
src/photogrammetrie/util/PclUtils.cpp:75-89, 401-460;
src/photogrammetrie/util/OpenMvsUtils.cpp:214-448). This package builds the
equivalent tier from `src/native.cpp` with g++ on first use into
sfm_mvs_pipeline_tpu_torch/build/ (keyed by source hash) and exposes it
through ctypes. This is host code, not a device kernel: every entry point
keeps the JAX package's pure-numpy fallback, taken where no toolchain exists
or when SFM_TORCH_NO_NATIVE is set; `available()` reports which tier is live.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build_and_load() -> ctypes.CDLL | None:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"libsfm_native_{tag}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (subprocess.SubprocessError, OSError):
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None

    lib.sfm_knn_kth.restype = ctypes.c_int
    lib.sfm_knn_kth.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.sfm_knn_all.restype = ctypes.c_int
    lib.sfm_knn_all.argtypes = lib.sfm_knn_kth.argtypes
    lib.sfm_write_ply.restype = ctypes.c_int
    lib.sfm_write_ply.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    return lib


def _lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _LIB = None if os.environ.get("SFM_TORCH_NO_NATIVE") else _build_and_load()
            _TRIED = True
    return _LIB


def available() -> bool:
    """True when the compiled native tier is loaded (builds it on first
    call)."""
    return _lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def knn_kth_distance(points: np.ndarray, k: int = 1) -> np.ndarray | None:
    """Distance to the k-th nearest neighbor per point via the C++ kd-tree;
    None if the native tier is unavailable (caller falls back)."""
    lib = _lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected (N, 3) points, got {pts.shape}")
    out = np.empty(len(pts), np.float32)
    rc = lib.sfm_knn_kth(_fptr(pts), len(pts), int(k), _fptr(out))
    return out.astype(np.float64) if rc == 0 else None


def knn_all_distances(points: np.ndarray, k: int) -> np.ndarray | None:
    """(N, k) sorted NN distances per point (self excluded)."""
    lib = _lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty((len(pts), k), np.float32)
    rc = lib.sfm_knn_all(_fptr(pts), len(pts), int(k), _fptr(out))
    return out.astype(np.float64) if rc == 0 else None


def write_ply_native(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    normals: np.ndarray | None = None,
    faces: np.ndarray | None = None,
) -> bool:
    """Binary PLY via the C++ writer. Returns False when unavailable."""
    lib = _lib()
    if lib is None:
        return False
    pts = np.ascontiguousarray(points, np.float32)
    rgb = None if colors is None else np.ascontiguousarray(colors[:, :3], np.uint8)
    nrm = None if normals is None else np.ascontiguousarray(normals, np.float32)
    fcs = None if faces is None else np.ascontiguousarray(faces, np.int32)
    rc = lib.sfm_write_ply(
        path.encode(),
        len(pts),
        _fptr(pts),
        None if rgb is None else rgb.ctypes.data,
        None if nrm is None else nrm.ctypes.data,
        0 if fcs is None else len(fcs),
        None if fcs is None else fcs.ctypes.data,
    )
    return rc == 0

