"""pcl-stats subcommand: NN-distance statistics for a PLY point cloud.

Port of sfm_mvs_pipeline_tpu/cli/pcl_stats.py, after PclStatsCli (ref:
src/cli/PclStatsCli.cpp:30-65): loads a PLY, writes `<stats>.csv`
(NN-distance stats), `<neighbors>.csv` (histogram) and `<quality>.ply` (the
quality-colored cloud; a mesh keeps its faces). Host work: the native C++
kd-tree when built, else numpy.
"""

from __future__ import annotations

import os

from sfm_mvs_pipeline_tpu_torch.utils import logger as logging
from sfm_mvs_pipeline_tpu_torch.utils.args import AppArgs

log = logging.AppLogger("PclStatsCli")


def print_usage() -> None:
    print(
        """pcl-stats — point cloud nearest-neighbor statistics

  -Pinput=<file.ply>      input cloud (default pointcloud.ply)
  -Pstats=<file.csv>      stats output (default <input>.stats.csv)
  -Pneighbors=<file.csv>  histogram output (default <input>.neighbors.csv)
  -Pquality=<file.ply>    quality-colored cloud (default <input>.quality.ply)
  --help"""
    )


def main(args: AppArgs) -> int:
    if args.is_flag("help"):
        print_usage()
        return 0

    from sfm_mvs_pipeline_tpu_torch.utils.ply import read_ply
    from sfm_mvs_pipeline_tpu_torch.utils.stats import write_pcl_stats

    inp = args.get("input", "pointcloud.ply")
    base = os.path.splitext(inp)[0]
    data = read_ply(inp)
    pts = data.get("points")
    if pts is None or len(pts) == 0:
        log.error(f"no points in {inp}")
        return 1
    log.info(f"{len(pts)} points loaded from {inp}")
    st = write_pcl_stats(pts, args.get("stats", base + ".stats.csv"),
                         args.get("neighbors", base + ".neighbors.csv"),
                         args.get("quality", base + ".quality.ply"), os.path.basename(base),
                         data.get("faces"))
    log.info(f"NN distance: mean {st['mean']:.4f} median {st['median']:.4f}")
    log.info("done")
    return 0
