"""K1's bf16 route's share of its roofline: the least time the 2-NN of each
set's inputs needs on the card (reference/roofline.py::two_nn_bound over
the valid descriptors of each shot in the set's scene.npz, the pair table
of the configuration's pairing policy, bf16 peak, 2 bytes a value, as the
+-1 expansion of ORB's bits takes K1's bf16 route), summed over the sets,
over the device time of the `two_nn_bf16_kernel` events in the window.
Each set launches K1 once. None without such an event or an output."""

import os

import numpy as np

from h100bench.metrics.k1_roofline_pct import _shape
from h100bench.reference.pairs import pairs_of
from h100bench.reference.roofline import two_nn_bound

KERNEL = "two_nn_bf16_kernel"


def read(ctx: dict) -> float | None:
    spent = sum(b - a for name, a, b in ctx["events"] if KERNEL in name) / 1e9
    if spent <= 0 or not ctx["outputs"]:
        return None
    least = 0.0
    for out in ctx["outputs"]:
        npz = os.path.join(out, "scene.npz")
        with np.load(npz) as z:
            counts = z["feat_valid"].sum(axis=1)
        pairs = pairs_of(ctx["config"]["flags"], len(counts))
        least += two_nn_bound(counts, pairs, _shape(npz, "descriptors")[-1], "bf16",
                              op_bytes=2)["bound_s"]
    return 100.0 * least / spent
