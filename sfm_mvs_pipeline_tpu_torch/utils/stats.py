"""Statistics suite: descriptive stats, reprojection/NN CSVs, resource sampler.

Replaces, with CSV-format parity:
  * MathUtils::calculateStatistics (min/max/mean/variance(n-1)/stddev/median;
    ref: src/photogrammetrie/util/MathUtils.h:53-90)
  * SceneUtils reprojection-error stats + histogram CSVs
    (ref: src/photogrammetrie/util/SceneUtils.cpp:28-144)
  * PclUtils nearest-neighbor stats/histogram CSVs + quality-colored PLY
    (ref: src/photogrammetrie/util/PclUtils.cpp:91-399)
  * AppStatistics 1 s resource sampler -> app.stat.csv
    (ref: src/cli/util/AppStatistics.cpp:70-150)
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np


def calculate_statistics(values: np.ndarray) -> dict:
    """min/max/mean/variance (n-1)/stddev/median, reference semantics."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return {
            "count": 0, "min": 0.0, "max": 0.0, "mean": 0.0,
            "variance": 0.0, "stddev": 0.0, "median": 0.0,
        }
    var = float(v.var(ddof=1)) if v.size > 1 else 0.0
    return {
        "count": int(v.size),
        "min": float(v.min()),
        "max": float(v.max()),
        "mean": float(v.mean()),
        "variance": var,
        "stddev": float(np.sqrt(var)),
        "median": float(np.median(v)),
    }


def _write_stats_csv(path: str, stats: dict, label: str) -> None:
    with open(path, "w") as f:
        f.write(f"name;count;min;max;mean;variance;stddev;median\n")
        f.write(
            f"{label};{stats['count']};{stats['min']};{stats['max']};"
            f"{stats['mean']};{stats['variance']};{stats['stddev']};"
            f"{stats['median']}\n"
        )


def _write_histogram_csv(path: str, values: np.ndarray, resolution: float) -> None:
    """Histogram CSV with bin = floor(v / resolution) like the reference's
    auto-binned (resolution = variance) histograms (SceneUtils.cpp:82-144)."""
    v = np.asarray(values, np.float64)
    if v.size == 0 or resolution <= 0:
        with open(path, "w") as f:
            f.write("bin;count\n")
        return
    bins = np.floor(v / resolution).astype(np.int64)
    uniq, counts = np.unique(bins, return_counts=True)
    with open(path, "w") as f:
        f.write("bin;count\n")
        for b, c in zip(uniq, counts):
            f.write(f"{b * resolution};{c}\n")


# ----------------------------------------------------- reprojection errors
def reprojection_errors(scene) -> np.ndarray:
    """Per-live-observation reprojection error (px), the quantity the
    reference aggregates over every origin of every point.

    Host float64 numpy: a few hundred projections, more precise than the
    device's float32."""
    live = scene.obs_w > 0
    X = scene.points[scene.obs_point[live]].astype(np.float64)
    poses = scene.poses[scene.obs_shot[live]].astype(np.float64)
    intr = scene.intrinsics[scene.cam_of_shot[scene.obs_shot[live]]].astype(
        np.float64
    )
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np

    R = aa_to_rotmat_np(poses[:, :3])  # (O, 3, 3)
    Xc = np.einsum("oab,ob->oa", R, X) + poses[:, 3:]
    z = np.where(Xc[:, 2] == 0, 1e-12, Xc[:, 2])
    xy = Xc[:, :2] / z[:, None]
    x, y = xy[:, 0], xy[:, 1]
    f, cx, cy = intr[:, 0], intr[:, 1], intr[:, 2]
    k1, k2, p1, p2 = intr[:, 3], intr[:, 4], intr[:, 5], intr[:, 6]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + k2 * r2)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    uv = np.stack([xd * f + cx, yd * f + cy], axis=1)
    return np.linalg.norm(uv - scene.obs_uv[live], axis=1)


def write_reprojection_stats(scene, out_dir: str, prefix: str = "reprojectionerror"):
    errs = reprojection_errors(scene)
    st = calculate_statistics(errs)
    _write_stats_csv(os.path.join(out_dir, f"{prefix}.stat.csv"), st, prefix)
    res = st["variance"] if st["variance"] > 0 else 1.0
    _write_histogram_csv(
        os.path.join(out_dir, f"{prefix}.histogram.csv"), errs, res
    )
    return st


# ------------------------------------------------------------ NN distances
def knn_distances(points: np.ndarray, k: int = 1, chunk: int = 2048) -> np.ndarray:
    """Distance to the k-th nearest neighbor per point. Uses the native C++
    kd-tree (O(N log N), OpenMP queries — native/src/native.cpp, the PCL
    KdTreeFLANN equivalent) when built, with a chunked brute-force numpy
    fallback."""
    n = len(points)
    if n <= k:
        return np.zeros(n)
    from sfm_mvs_pipeline_tpu_torch import native

    d = native.knn_kth_distance(np.asarray(points, np.float32), k)
    if d is not None:
        return d
    out = np.empty(n)
    pts = points.astype(np.float32)
    for s in range(0, n, chunk):
        blk = pts[s : s + chunk]
        d2 = ((blk[:, None] - pts[None]) ** 2).sum(-1)
        idx = np.arange(s, min(s + chunk, n))
        d2[np.arange(len(blk)), idx] = np.inf  # self
        out[s : s + chunk] = np.sqrt(np.partition(d2, k - 1, axis=1)[:, k - 1])
    return out


def write_pcl_stats(points: np.ndarray, stats_path: str, neighbors_path: str,
                    quality_path: str, label: str, faces: np.ndarray | None = None) -> dict:
    """The pcl-stats outputs (PclStatsCli.cpp:47-63): NN-distance stats CSV,
    neighbor histogram CSV and the quality-colored PLY, linear red (largest
    NN distance) to blue (smallest); a mesh keeps its faces, like the
    reference's writeToNeighborPLY (PclUtils.cpp:91-265)."""
    from sfm_mvs_pipeline_tpu_torch.utils.ply import write_ply_mesh, write_ply_points

    d = knn_distances(points)
    st = calculate_statistics(d)
    _write_stats_csv(stats_path, st, label)
    res = st["variance"] if st["variance"] > 0 else 1.0
    _write_histogram_csv(neighbors_path, d, res)
    if len(d):
        t = (d - d.min()) / max(d.max() - d.min(), 1e-12)
        colors = np.stack([(t * 255).astype(np.uint8), np.zeros(len(d), np.uint8),
                           ((1 - t) * 255).astype(np.uint8)], axis=1)
        if faces is not None and len(faces):
            write_ply_mesh(quality_path, points, faces, colors=colors)
        else:
            write_ply_points(quality_path, points, colors)
    return st


# ---------------------------------------------------------- resource sampler
class ResourceSampler:
    """Background thread sampling process CPU%/RSS/threads every interval
    into app.stat.csv (AppStatistics parity: sysinfo + /proc/self/stat)."""

    def __init__(self, path: str, interval: float = 1.0):
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _read_proc(self):
        with open("/proc/self/stat") as f:
            parts = f.read().split()
        utime, stime = int(parts[13]), int(parts[14])
        threads = int(parts[19])
        rss_pages = int(parts[23])
        state = parts[2]
        return utime, stime, threads, rss_pages, state

    @staticmethod
    def _device_mem() -> tuple[int, int]:
        """(bytes_in_use, bytes_limit) of CUDA device 0, or (0, 0) when the
        process has not initialised CUDA (the sampler thread never does)."""
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return (0, 0)
        stats = torch.cuda.memory_stats(0)
        return (
            int(stats.get("allocated_bytes.all.current", 0)),
            int(torch.cuda.get_device_properties(0).total_memory),
        )

    def _run(self) -> None:
        clk = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        t_prev = time.time()
        u_prev, s_prev, *_ = self._read_proc()
        start = t_prev
        with open(self.path, "w") as f:
            f.write(
                "elapsed_s;total_mem_bytes;free_mem_bytes;"
                "cpu_percent;threads;state;rss_bytes;"
                "device_mem_used_bytes;device_mem_limit_bytes\n"
            )
            f.flush()
            while not self._stop.wait(self.interval):
                try:
                    u, s, threads, rss, state = self._read_proc()
                    now = time.time()
                    dt_wall = max(now - t_prev, 1e-9)
                    cpu = ((u - u_prev) + (s - s_prev)) / clk / dt_wall * 100.0
                    mem = os.sysconf("SC_PHYS_PAGES") * page
                    free = os.sysconf("SC_AVPHYS_PAGES") * page
                    dmem, dlim = self._device_mem()
                    f.write(
                        f"{now - start:.1f};{mem};{free};{cpu:.1f};"
                        f"{threads};{state};{rss * page};{dmem};{dlim}\n"
                    )
                    f.flush()
                    t_prev, u_prev, s_prev = now, u, s
                except Exception:
                    break
