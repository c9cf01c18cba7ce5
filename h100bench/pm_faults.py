"""Faults planted in the PatchMatch cell: broken runs' readings, for its
limits (limits/grid-sift-flann-pm.dense-pm-1080p.json, PERF.md).

    python3 h100bench/pm_faults.py --workload grid-sift-flann-pm.dense-pm-1080p --seeds 1 --runs all

Beside the dense faults of faults.py that act on PatchMatch's path (half
of the views' depth maps left out, the fused points altered, the atlas
left blank; SGM's never runs here), two of PatchMatch's own:
  * PatchMatch returns its random initialisation: every rectified pair
    runs no iteration, so no candidate propagates or is searched;
  * the consensus is skipped: a view takes its first neighbour's depth as
    it is, gated by that neighbour's cost alone.
The arguments are faults.py's. The benchmark's runs never run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import faults  # noqa: E402

PM = "grid-sift-flann-pm.dense-pm-1080p"
PORT = faults.PORT


def _pm_returns_its_init(inner, views):
    def pair(*args, **kwargs):
        return inner(*args, **{**kwargs, "iterations": 0})
    return pair


def _consensus_skipped(inner, views):
    def fuse(depths, costs, valids, rel_tol=0.02, min_support=2, max_cost=0.4):
        return depths[0], costs[0], valids[0] & (costs[0] <= max_cost)
    return fuse


PM_FAULTS = {
    "PatchMatch returns its random initialisation":
        [(f"{PORT}.mvs.patchmatch", "_pm_rect_pair", _pm_returns_its_init)],
    "the consensus skipped: the first neighbour's depth as it is":
        [(f"{PORT}.mvs.rectified", "consensus_fuse", _consensus_skipped)],
    **{name: plants for name, plants in faults.FAULTS[faults.DENSE].items()
       if "SGM" not in name},
}


def register() -> None:
    """Make the PatchMatch cell's faults known to faults.py."""
    faults.FAULTS[PM] = PM_FAULTS


if __name__ == "__main__":
    register()
    sys.exit(faults.main())
