"""faults.py's sparse faults planted in the ORB cell: broken runs' readings,
beside the control's (orb_control.py), for its limits
(limits/unordered-orb-bf.sparse-1080p.json, PERF.md).

    python3 h100bench/orb_faults.py --workload unordered-orb-bf.sparse-1080p --seeds 1 --runs all

The ORB cell runs the sparse job the SIFT cell runs, so the same faults
(FAULTS[SPARSE]: bundle adjustment returning its state, half of the image
batch blank, a pose altered where it is written) apply to it unchanged.
The arguments are faults.py's. The benchmark's runs never run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import faults  # noqa: E402

ORB = "unordered-orb-bf.sparse-1080p"

if __name__ == "__main__":
    faults.FAULTS[ORB] = faults.FAULTS[faults.SPARSE]
    sys.exit(faults.main())
