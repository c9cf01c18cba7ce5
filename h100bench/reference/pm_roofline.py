"""The least time K3's work needs on the card: PatchMatch's candidate
scoring counted whatever implements it.

`k3_bound` counts as chip_smoke.py's `k3_bound` does at commit
f1cd11cbfe766c3f7d339ceb0a0e27d1fd6ef51f (there in milliseconds, here in
seconds): per active (pixel, candidate), (2r+1)^2 window samples of 8 fp32
operations (bilinear 3, three sums 5) and 16 for the window statistics;
bytes: the active candidates read, every cost written, the four (H, W)
float32 maps and the (H, W) byte mask read. `k3_bound_of_counts` takes the
same quantities summed over launches, as the program's counters give them
(ops/kernels/pm_kernel.py::pm_score_rect), so the window radius and the
form may differ launch by launch.
"""

from __future__ import annotations

from . import roofline


def k3_bound_of_counts(candidate_pixels: float, window_samples: float, pixels: float,
                       costs: float) -> dict:
    """Bound of K3 launches whose sums are: active (pixel, candidate) pairs,
    window samples over them ((2r+1)^2 each), H W of each launch, and costs
    written (C H W of each launch)."""
    flops = 8.0 * window_samples + 16.0 * candidate_pixels
    nbytes = 4.0 * candidate_pixels + 4.0 * costs + (4 * 4.0 + 1.0) * pixels
    return roofline.bound(nbytes, flops, "fp32")


def k3_bound(C: int, H: int, W: int, r: int, parity) -> dict:
    """Bound of one launch at C candidate maps of (H, W), radius r; with
    `parity` 0 or 1 only that checkerboard parity's pixels are active."""
    n_act = H * W if parity is None else (H * W + (1 - parity)) // 2
    return k3_bound_of_counts(C * n_act, C * n_act * (2 * r + 1) ** 2, H * W, C * H * W)
