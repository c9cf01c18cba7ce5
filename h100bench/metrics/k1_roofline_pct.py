"""K1's share of its roofline: the least time the 2-NN of a set's inputs
needs on the card (reference/roofline.py::two_nn_bound over the valid
descriptors of each shot in the set's scene.npz and the pair table of the
configuration's pairing policy, fp32 peak, as SIFT's descriptors take K1's
fp32 route), over the device time of the K1 kernels below in the window.
Each set launches K1 once. None without a K1 event, or for ORB's binary
descriptors (their bf16 route needs its own count)."""

import os
import zipfile

import numpy as np

from h100bench.reference.pairs import pairs_of
from h100bench.reference.roofline import two_nn_bound

KERNELS = ("two_nn_f32_kernel", "two_nn_bf16_kernel")


def _shape(npz: str, key: str) -> tuple:
    with zipfile.ZipFile(npz) as z, z.open(f"{key}.npy") as f:
        major, _ = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if major == 1
                       else np.lib.format.read_array_header_2_0)
        return read_header(f)[0]


def read(ctx: dict) -> float | None:
    flags = ctx["config"]["flags"]
    spent = sum(b - a for name, a, b in ctx["events"] if any(k in name for k in KERNELS)) / 1e9
    if spent <= 0 or not ctx["outputs"] or "-Pfeature-detector=ORB" in flags:
        return None
    npz = os.path.join(ctx["outputs"][0], "scene.npz")
    with np.load(npz) as z:
        counts = z["feat_valid"].sum(axis=1)
    D = _shape(npz, "descriptors")[-1]
    least = two_nn_bound(counts, pairs_of(flags, len(counts)), D, "fp32")["bound_s"]
    return 100.0 * least * ctx["sets"] / spent
