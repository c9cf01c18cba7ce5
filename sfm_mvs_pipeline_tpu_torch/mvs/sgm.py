"""Semi-global matching: 4-path cost-volume aggregation.

Port of sfm_mvs_pipeline_tpu/mvs/sgm.py (the reference's --sgm path,
ref: src/photogrammetrie/mvs/MVS.cpp:113-116). Per path direction r,
  L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                             L_r(p-r, d+-1) + P1,
                             min_d' L_r(p-r, d') + P2 ) - min_d' L_r(p-r, d')
aggregated over 4 directions (left/right/up/down).

This module holds the plain PyTorch versions of the two SGM kernels
(ops/kernels/sgm_kernel.py, csrc/sgm_kernel.cu): a Python loop over the
scan axis of torch ops over (lines, D). They keep the kernels' operation
order, `c + (best - m)` (sgm.py:36-40 and sgm_kernel.py:37-40 of the JAX
package), so each kernel is bit-equal to its plain version; the kernels
sum two directions in another order only where IEEE arithmetic gives the
same bits (a + b == b + a, 0 + x == x). Volumes are (H, W, D), d fastest;
`axis` names the scan axis (0 = H, 1 = W).
"""

from __future__ import annotations

import torch


def _step(prev: torch.Tensor, c: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """One SGM update over (L, D): prev, c -> c + (best - m). The edge rule
    of the JAX kernel: d = 0 and d = D-1 use their own value + P1 for the
    missing neighbour."""
    m = prev.amin(dim=-1, keepdim=True)
    up = torch.cat([prev[:, :1] + p1, prev[:, :-1] + p1], dim=1)
    dn = torch.cat([prev[:, 1:] + p1, prev[:, -1:] + p1], dim=1)
    best = torch.minimum(torch.minimum(prev, up), torch.minimum(dn, m + p2))
    # best - m first: it is bounded by p2, so c is not cancelled
    return c + (best - m)


def _scan_dir(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Aggregate along axis 0 of cost (S, L, D): S = scan steps, L = lines."""
    out = torch.empty_like(cost)
    prev = cost[0]
    out[0] = prev
    for s in range(1, cost.shape[0]):
        prev = _step(prev, cost[s], p1, p2)
        out[s] = prev
    return out


def _lines_first(v: torch.Tensor, axis: int) -> torch.Tensor:
    """(H, W, D) -> (S, L, D) view with the scan axis first."""
    return v if axis == 0 else v.transpose(0, 1)


def sgm_bidir_plain(cost_hwd: torch.Tensor, p1: float, p2: float, axis: int) -> torch.Tensor:
    """Plain version of K2a: forward + backward SGM along `axis` of
    (H, W, D), summed. Returns a new (H, W, D) f32 volume."""
    v = _lines_first(cost_hwd, axis)
    fwd = _scan_dir(v, p1, p2)
    bwd = _scan_dir(v.flip(0), p1, p2).flip(0)
    return _lines_first(fwd + bwd, axis).contiguous()


def sgm_dir_acc_plain(cost_hwd: torch.Tensor, acc: torch.Tensor, p1: float, p2: float,
                      axis: int, reverse: bool) -> torch.Tensor:
    """Plain version of K2b: acc += L_r for one direction along `axis`,
    IN PLACE on `acc` (H, W, D) f32; `cost_hwd` is the bf16 cost, read as
    f32. Returns acc."""
    c = _lines_first(cost_hwd, axis)
    a = _lines_first(acc, axis)  # a view: the adds below land in acc
    n = c.shape[0]
    order = range(n - 1, -1, -1) if reverse else range(n)
    prev = None
    for s in order:
        cs = c[s].float()
        prev = cs if prev is None else _step(prev, cs, p1, p2)
        a[s] += prev
    return acc


def sgm_hpair_plain(cost_hwd: torch.Tensor, p1: float, p2: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2b's horizontal pair (ops/kernels/sgm_kernel.py::
    sgm_hpair): the f32 cost rounded to bf16 (round to nearest even, as the
    kernel's __float2bfloat16_rn), and L_forward + L_backward along W over
    the rounded cost. Returns (acc f32, the bf16 cost)."""
    cv = cost_hwd.to(torch.bfloat16).contiguous()
    return sgm_bidir_plain(cv.float(), p1, p2, axis=1), cv


def staged_sum(cost_hwd: torch.Tensor, p1: float, p2: float, hpair, dir_acc) -> torch.Tensor:
    """The memory-staged 4-path SGM of the JAX package's sgm_staged_hwd:
    the cost rounded to bf16 once, one f32 accumulator, and the four
    directions added in the JAX order, horizontal forward, horizontal
    backward, vertical forward, vertical backward (sgm_kernel.py:239-251),
    so the sum is ((0 + Lhf) + Lhb) + Lvf) + Lvb.

    On the card this is K2b, which replaces the TPU kernel `_sgm_dir_kernel`
    and is bound by bytes (ops/kernels/sgm_kernel.py, csrc/sgm_kernel.cu):
    `hpair` (sgm_hpair, or sgm_hpair_plain) is one launch in which two warps
    a line scan forward and backward at once through a prefetch ring and
    meet in the middle; it rounds the f32 cost, writes the bf16 copy and
    returns Lhf + Lhb. 0 + Lhf == Lhf and Lhf + Lhb == Lhb + Lhf, so no
    zero-filled accumulator is read and there is no separate rounding
    pass. `dir_acc` (sgm_dir_acc, or sgm_dir_acc_plain) then adds Lvf and
    Lvb in place, in that order, one launch each. Returns the UNNORMALISED
    4-path sum (H, W, D); unlike the JAX package the D axis is not padded."""
    acc, cv = hpair(cost_hwd, p1, p2)
    for reverse in (False, True):
        dir_acc(cv, acc, p1, p2, axis=0, reverse=reverse)
    return acc


def sgm_aggregate(
    cost_volume: torch.Tensor,  # (D, H, W)
    p1: float = 0.03,
    p2: float = 0.3,
) -> torch.Tensor:
    """4-path SGM aggregation. Returns the aggregated volume (D, H, W),
    normalised by the number of paths so downstream thresholds keep scale.

    Dispatcher: K2a on a CUDA tensor, its plain version on a CPU tensor
    (ops/kernels/sgm_kernel.py::sgm_bidir). The directions are summed in the
    JAX package's TPU order, ((lr + rl) + (tb + bt)) / 4 (sgm.py:64-68)."""
    from sfm_mvs_pipeline_tpu_torch.ops.kernels.sgm_kernel import sgm_bidir

    v = cost_volume.permute(1, 2, 0).contiguous()  # (H, W, D)
    horiz = sgm_bidir(v, p1, p2, axis=1)  # scan over W, both ways
    vert = sgm_bidir(v, p1, p2, axis=0)  # scan over H, both ways
    agg = (horiz + vert) / 4.0
    return agg.permute(2, 0, 1)
