"""K3's active-parity scoring on the CPU: pm_score_rect_plain(parity=p)
against its full form and the JAX package's scorer (interpret mode), the
wrapper's `parity` on the CPU, and _pm_rect_pair, whose
half-iterations now score one parity, against the same pair scored in
full.

Tolerances: 0 between the port's own forms (the parity form is the full
form with the inactive pixels set to 1); atol 1e-5 against the Pallas
kernel in interpret mode, as tests/test_torch_patchmatch.py holds the full
form (its window sums run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu.mvs.plane_sweep import _box_filter
from sfm_mvs_pipeline_tpu.ops.pallas.pm_kernel import pm_score_rect as j_score
from sfm_mvs_pipeline_tpu_torch.mvs import patchmatch as TPM
from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3

torch.set_num_threads(2)


def _inputs(r, h, w, maxd, seed):
    rng = np.random.default_rng(seed)
    area = (2 * r + 1) ** 2
    ref, nbr = rng.random((2, h, w)).astype(np.float32)
    in_n = rng.random((h, w)) > 0.05
    in_n[:, :5] = False
    cands = (rng.random((3, h, w)) * maxd).astype(np.float32)
    cands[1, 2] = np.floor(cands[1, 2])  # integral disparities: frac = 0
    r_mean = (np.asarray(_box_filter(jnp.asarray(ref), r)) / area).astype(np.float32)
    r_sq = np.asarray(_box_filter(jnp.asarray(ref * ref), r)) / area
    r_var = np.maximum(r_sq - r_mean * r_mean, 1e-8).astype(np.float32)
    return cands, ref, nbr, in_n, r_mean, r_var


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("r,h,w,maxd", [(2, 14, 72, 64), (3, 9, 41, 30)])
def test_plain_parity_form(parity, r, h, w, maxd):
    """Active pixels ((y + x) % 2 == parity) keep the full form's cost bit
    for bit and agree with the Pallas kernel; the others cost 1. The odd
    width puts an active pixel in the last column on every other row."""
    args = _inputs(r, h, w, maxd, seed=r * 10 + w + parity)
    full = TPM.pm_score_rect_plain(*map(_t, args), maxd=maxd, window_radius=r)
    part = TPM.pm_score_rect_plain(*map(_t, args), maxd=maxd, window_radius=r, parity=parity)
    ys, xs = np.mgrid[:h, :w]
    active = torch.from_numpy((ys + xs) % 2 == parity)
    assert torch.equal(part[:, active], full[:, active])
    assert (part[:, ~active] == 1.0).all()
    want_j = np.asarray(j_score(*map(jnp.asarray, args), maxd=maxd, window_radius=r,
                                interpret=True))
    np.testing.assert_allclose(part.numpy()[:, active.numpy()], want_j[:, active.numpy()],
                               atol=1e-5)


@pytest.mark.parametrize("parity", [None, 0, 1])
def test_wrapper_parity_and_zeroed_neighbour_on_cpu(parity):
    """On the CPU the wrapper runs the plain version with the parity, counts
    no launch, and a neighbour already zeroed at its invalid pixels (what
    the kernel reads on the card) gives the same costs as the raw one."""
    cands, ref, nbr, in_n, r_mean, r_var = _inputs(3, 12, 50, 40, seed=3)
    nbr_z = np.where(in_n, nbr, 0).astype(np.float32)
    before = K3.pm_score_rect.launches
    raw = K3.pm_score_rect(*map(_t, (cands, ref, nbr, in_n, r_mean, r_var)), maxd=40,
                           parity=parity)
    zeroed = K3.pm_score_rect(*map(_t, (cands, ref, nbr_z, in_n, r_mean, r_var)), maxd=40,
                              parity=parity)
    plain = TPM.pm_score_rect_plain(*map(_t, (cands, ref, nbr, in_n, r_mean, r_var)), maxd=40,
                                    parity=parity)
    assert torch.equal(raw, plain) and torch.equal(zeroed, plain)
    assert K3.pm_score_rect.launches == before


def test_plain_rejects_bad_parity():
    args = map(_t, _inputs(2, 6, 20, 10, seed=0))
    with pytest.raises(ValueError):
        TPM.pm_score_rect_plain(*args, maxd=10, window_radius=2, parity=2)


def test_pm_rect_pair_parity_scoring_bit_equal_to_full(monkeypatch):
    """_pm_rect_pair scores one parity per half-iteration; its depth, cost
    and validity are bit-equal to the same pair with every half-iteration
    scored in full, since a half-iteration keeps only its parity's pixels."""
    rng = np.random.default_rng(11)
    h, w, f, b, z = 24, 56, 50.0, 1.0, 5.0
    tex = rng.random((h, w + 32)).astype(np.float32)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3.0
    di = int(f * b / z)
    ref, nbr = tex[:, 16:16 + w], tex[:, 16 + di:16 + di + w]
    pose_r = np.zeros(6, np.float32)
    pose_n = np.array([0.003, -0.004, 0.002, -b, 0, 0], np.float32)
    intr = np.asarray([f, w / 2, h / 2, 0, 0, 0, 0], np.float32)
    it = 3
    u0 = rng.random((h, w)).astype(np.float32)
    halves = [tuple(rng.random((2, h, w)).astype(np.float32)) for _ in range(2 * it)]
    args = tuple(map(_t, (ref, nbr, pose_r, pose_n, intr))) + (2.0, 12.0)
    kw = dict(draws=(u0, halves), iterations=it, window_radius=2, max_disp=64)
    calls = []
    orig = K3.pm_score_rect

    def spy(*a, **k):
        calls.append(k.get("parity"))
        return orig(*a, **k)

    monkeypatch.setattr(K3, "pm_score_rect", spy)
    got = TPM._pm_rect_pair(*args, **kw)
    assert calls == [None] + [0, 1] * it
    monkeypatch.setattr(K3, "pm_score_rect", lambda *a, **k: orig(*a, **{**k, "parity": None}))
    want = TPM._pm_rect_pair(*args, **kw)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    assert bool(got[2].any())
