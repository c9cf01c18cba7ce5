"""Pair tables of the CLI's pairing policies.

Copies of sfm_mvs_pipeline_tpu_torch/ops/pairs.py's `unordered_pairs`,
`video_pairs` and `grid_pairs` at commit
c39858ae74ef4e5e9718c7b51256d4a817b4f69c, and of the CLI's choice among
them (cli/photogrammetrie.py: -Pfeature-gridlength > 0 takes the grid with
max(-Pfeature-sequence, 2), else -Pfeature-sequence > 0 the sequence, else
all pairs). The K1 bound counts the work of these pairs.
"""

from __future__ import annotations

import numpy as np


def unordered_pairs(n_shots: int) -> np.ndarray:
    """All unordered pairs (i, j), i < j."""
    idx = np.triu_indices(n_shots, k=1)
    return np.stack([idx[0], idx[1]], axis=1).astype(np.int32)


def video_pairs(n_shots: int, sequence_length: int = 3) -> np.ndarray:
    """Sliding-window pairs: (i, i+d) for d in [1, sequence_length-1]."""
    pairs = [(i, i + d) for i in range(n_shots) for d in range(1, sequence_length)
             if i + d < n_shots]
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def grid_pairs(n_shots: int, row_length: int, sequence_length: int = 2) -> np.ndarray:
    """Triangular grid-neighbourhood pairs: image k at (k // row_length,
    k % row_length) with every in-grid image at offset (di, dj), di, dj >= 0,
    0 < di + dj < sequence_length."""
    pairs = []
    for k in range(n_shots):
        r, c = divmod(k, row_length)
        for di in range(sequence_length):
            for dj in range(sequence_length - di):
                if di == 0 and dj == 0:
                    continue
                r2, c2 = r + di, c + dj
                if c2 >= row_length:
                    continue
                k2 = r2 * row_length + c2
                if k2 >= n_shots:
                    continue
                pairs.append((k, k2))
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def flag_value(flags: list[str], key: str, default: int = 0) -> int:
    for a in flags:
        if a.startswith(f"-P{key}="):
            return int(a.split("=", 1)[1])
    return default


def pairs_of(flags: list[str], n_shots: int) -> np.ndarray:
    """The pair table the CLI builds from these flags."""
    grid_len = flag_value(flags, "feature-gridlength")
    seq = flag_value(flags, "feature-sequence")
    if grid_len > 0:
        return grid_pairs(n_shots, grid_len, max(seq, 2))
    if seq > 0:
        return video_pairs(n_shots, seq)
    return unordered_pairs(n_shots)
