"""The orders of the redesigned SGM kernels (csrc/sgm_kernel.cu) on the CPU.

K2b's staged route now runs the two horizontal directions in one launch,
whose first visitor of a position writes acc = L and whose second adds its
own L, and then the two vertical directions in turn; K2a runs a line's two
directions at once in two warps that meet in the middle. Both rest on
IEEE facts: a + b == b + a, and 0 + x == x by value. These tests hold the
plain forms of that order to the order they replace, bit for bit
(torch.equal; -0 and +0 count as equal), on random float32 costs:

  * the plain pair form and the new staged_sum against four sequential
    sgm_dir_acc_plain calls on a zeroed accumulator over the bf16-rounded
    cost, the staged route as it was;
  * a plain emulation of the kernels' meet-in-the-middle (each direction
    writes its L over the first half of the positions it visits, then adds
    it to the other's over the second) against sgm_bidir_plain, and, over
    the rounded cost, against the horizontal half of the staged route.

Shapes cover odd and even scan lengths, S = 1 and S = 2 on each axis, and
D = 1, 37 and 96.
"""

import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu_torch.mvs import sgm as TS
from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as TK

P1, P2 = 0.03, 0.3
SHAPES = [(5, 7, 37), (4, 6, 96), (1, 9, 1), (9, 1, 37), (2, 2, 96), (2, 3, 1), (6, 2, 37),
          (1, 1, 96), (3, 8, 96)]


def _cost(h, w, d):
    rng = np.random.default_rng(h * 1000 + w * 10 + d)
    return torch.from_numpy(rng.random((h, w, d), dtype=np.float32))


def _staged_before(cost):
    """The staged route as four sgm_dir_acc_plain calls on a zeroed
    accumulator over the bf16 cost: (acc after the horizontal pair, acc
    after all four, the bf16 cost)."""
    cv = cost.to(torch.bfloat16).contiguous()
    acc = torch.zeros(cost.shape, dtype=torch.float32)
    for reverse in (False, True):
        TS.sgm_dir_acc_plain(cv, acc, P1, P2, axis=1, reverse=reverse)
    horiz = acc.clone()
    for reverse in (False, True):
        TS.sgm_dir_acc_plain(cv, acc, P1, P2, axis=0, reverse=reverse)
    return horiz, acc, cv


def _meet_in_the_middle(cost, axis):
    """The kernels' order along `axis`, one line at a time in torch: the
    forward direction writes its L at positions 0 .. S/2-1 and the backward
    one at S-1 .. S/2; then each adds its L to the stored value over the
    other half (stored + own)."""
    v = TS._lines_first(cost, axis)  # (S, L, D)
    fwd = TS._scan_dir(v, P1, P2)
    bwd = TS._scan_dir(v.flip(0), P1, P2).flip(0)
    S = v.shape[0]
    out = torch.empty_like(v)
    out[: S // 2] = fwd[: S // 2]
    out[S // 2:] = bwd[S // 2:]
    out[S // 2:] = out[S // 2:] + fwd[S // 2:]
    out[: S // 2] = out[: S // 2] + bwd[: S // 2]
    return TS._lines_first(out, axis).contiguous()


@pytest.mark.parametrize("H,W,D", SHAPES)
def test_plain_pair_forms_equal_four_directions(H, W, D):
    cost = _cost(H, W, D)
    horiz, acc_4, cv = _staged_before(cost)
    acc_h, cv_h = TS.sgm_hpair_plain(cost, P1, P2)
    assert cv_h.dtype == torch.bfloat16 and torch.equal(cv_h, cv)
    assert torch.equal(acc_h, horiz)
    assert torch.equal(TS.staged_sum(cost, P1, P2, TS.sgm_hpair_plain, TS.sgm_dir_acc_plain),
                       acc_4)
    # the dispatcher on CPU tensors takes the plain forms
    assert torch.equal(TK.sgm_staged_hwd(cost, P1, P2), acc_4)


@pytest.mark.parametrize("H,W,D", SHAPES)
def test_meet_in_the_middle_keeps_the_bits(H, W, D):
    cost = _cost(H, W, D)
    for axis in (0, 1):  # K2a's order against its plain version
        assert torch.equal(_meet_in_the_middle(cost, axis), TS.sgm_bidir_plain(cost, P1, P2, axis))
    # the horizontal pair's order over the rounded cost against the first two
    # of the four sequential directions
    horiz, _, cv = _staged_before(cost)
    assert torch.equal(_meet_in_the_middle(cv.float(), 1), horiz)
