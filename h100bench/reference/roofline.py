"""The card's published peaks and the least time a kernel's work needs.

`PEAK_BYTES_S`, `PEAK_FLOP_S` and `bound` are copies of chip_smoke.py's at
commit c39858ae74ef4e5e9718c7b51256d4a817b4f69c (there `bound` returns
milliseconds; here seconds). `two_nn_bound` is chip_smoke.py's
`match_bound` counted over each shot's valid descriptors rather than over
the extents a kernel sweeps: the operations and bytes the 2-NN of these
inputs needs, whatever the kernel does beyond them.
"""

from __future__ import annotations

import numpy as np

# H100 SXM data sheet, dense rates without sparsity, at the 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"fp32": 67e12, "bf16": 989e12}


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOP_S[kind]
    return {"bound_s": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def two_nn_bound(counts, pairs: np.ndarray, D: int, kind: str, op_bytes: int = 4) -> dict:
    """Bound of the 2-NN over the pair table `pairs` (P, 2) of shots with
    `counts` (S,) valid descriptors of D values: 2 D n_q n_t operations a
    pair; bytes of each valid descriptor read once (op_bytes a value) and,
    for each valid query of each pair, the index, best and second distance
    (4 bytes each) written once."""
    n = np.asarray(counts, np.float64)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    flops = 2.0 * D * float((n[pairs[:, 0]] * n[pairs[:, 1]]).sum())
    nbytes = n.sum() * D * op_bytes + 3 * 4 * float(n[pairs[:, 0]].sum())
    return bound(nbytes, flops, kind)
