"""Kernels K1 (csrc/match_kernel.cu), K1x (csrc/match_exact_kernel.cu), K2a
and K2b (csrc/sgm_kernel.cu) and K3 (csrc/pm_kernel.cu) against their
plain PyTorch versions on the card. Needs a CUDA card and
nvcc; skipped elsewhere. This file imports no JAX, so on the card it runs
alone with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances: 0. K1 on integer-valued descriptors (every product and sum is
exact in fp32), which also pins the lowest-index tie rule; its bf16 route
on +-1 descriptors likewise. Where whole 128-query blocks lie past a
shot's valid extent, K1 is held to its extent contract: bit-equal at every
valid query, best^2 = BIG at every invalid one, equal ratio-test masks.
K3 in both forms (every pixel, one checkerboard parity). K1x sweeps
only valid slots, so it is held to the same extent contract: on
integer-valued descriptors (the bf16 lo parts are 0) bit-equal to the plain
version and to K1 at every valid query; on continuous ones its distances
at valid queries are within
1e-5 (|q|^2 + |t|^2) of its plain version (the products are exact in fp32,
the order of the fp32 sums differs) and idx is equal wherever best and
second lie farther apart than that. K2a and K2b are
mins, adds and subtracts in the plain versions' order (their sums of two
directions reordered only as a + b == b + a and 0 + x == x allow), so
they equal the plain versions bit for bit, on the card and on the CPU
alike. K3 rounds
every multiply, add, divide and square root on its own, in the plain
version's order, so it equals the plain version on the card bit for bit;
the plain version on the CPU differs from both by one ulp at a few
entries (6e-8 measured on an H100 host), so that comparison is held to
atol 1e-6. One case runs every kernel on tensors of cuda:1 while cuda:0 is
current (it needs two cards).
"""

import numpy as np
import pytest
import torch


@pytest.mark.gpu
@pytest.mark.parametrize("S,F,D", [(3, 200, 128), (2, 1000, 96), (2, 333, 256), (4, 64, 7)])
def test_k1_bit_equal_to_plain(S, F, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch

    rng = np.random.default_rng(S * 1000 + F + D)
    d = rng.integers(0, 256, size=(S, F, D)).astype(np.float32)
    for s in range(S):  # duplicated rows: exact ties
        d[s, rng.integers(0, F, F // 8)] = d[s, rng.integers(0, F, F // 8)]
    v = rng.random((S, F)) > 0.1
    pairs = np.array([(a, b) for a in range(S) for b in range(S) if a != b], np.int32)
    dt, vt, pt = (torch.from_numpy(x).cuda() for x in (d, v, pairs))
    before = K.two_nn_batch_fused.launches
    out_k = K.two_nn_batch_fused(dt, vt, pt)
    out_p = two_nn_batch(dt, vt, pt)
    torch.cuda.synchronize()
    assert K.two_nn_batch_fused.launches == before + 1
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_k1_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K

    d = torch.zeros((2, 64, 128), device="cuda")
    v = torch.ones((2, 64), dtype=torch.bool, device="cuda")
    p = torch.tensor([[0, 1]], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        K.two_nn_batch_fused(d.double(), v, p)
    with pytest.raises(ValueError):
        K.two_nn_batch_fused(d, v, p.long())
    with pytest.raises(ValueError):
        K.two_nn_batch_fused(d.transpose(1, 2).contiguous().transpose(1, 2), v, p)


def _pm1_with_ties(rng, S, F, D):
    d = (rng.integers(0, 2, size=(S, F, D)) * 2 - 1).astype(np.float32)
    for s in range(S):  # duplicated rows: exact ties
        d[s, rng.integers(0, F, F // 8)] = d[s, rng.integers(0, F, F // 8)]
    return d


def _assert_extent_contract(out_k, out_p, vt, pt):
    """K1's contract against the plain version: bit-equal at every valid
    query, best^2 = BIG at every invalid one, ratio-test masks equal."""
    from sfm_mvs_pipeline_tpu_torch.ops.matching import BIG, ratio_test_mask

    vq = vt[pt[:, 0].long()]
    for a, b in zip(out_k, out_p):
        assert torch.equal(a[vq], b[vq])
    assert bool((out_k[1][~vq] == BIG).all())
    assert torch.equal(ratio_test_mask(out_k[1], out_k[2], vq), ratio_test_mask(out_p[1], out_p[2], vq))


@pytest.mark.gpu
@pytest.mark.parametrize("S,F,D", [(3, 200, 256), (2, 1000, 128), (2, 333, 64), (4, 64, 7)])
def test_k1_bf16_route_bit_equal_to_plain(S, F, D):
    """The tensor-core route on bf16 +-1 descriptors with ties and holes:
    every sum is an exact integer, so idx, best^2 and second^2 equal the
    plain version's (the float32 run) and the fp32 route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch

    rng = np.random.default_rng(S * 1000 + F + D + 2)
    d = _pm1_with_ties(rng, S, F, D)
    v = rng.random((S, F)) > 0.1
    v[:, -1] = True  # the extent is the capacity: every block is swept
    pairs = np.array([(a, b) for a in range(S) for b in range(S) if a != b], np.int32)
    dt, vt, pt = (torch.from_numpy(x).cuda() for x in (d, v, pairs))
    before = K.two_nn_batch_fused.launches
    out_b = K.two_nn_batch_fused(dt.to(torch.bfloat16), vt, pt)
    out_f = K.two_nn_batch_fused(dt, vt, pt)
    out_p = two_nn_batch(dt, vt, pt)
    torch.cuda.synchronize()
    assert K.two_nn_batch_fused.launches == before + 2
    for a, b, c in zip(out_b, out_p, out_f):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["prefix", "holes"])
def test_k1_extent_contract(route, kind):
    """Prefix-valid shots (ORB's top-k layout: 11%, none, 40%, all of the
    slots) and holed ones with an invalid tail, so whole query blocks and
    target tiles lie past the extent, under the extent contract."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch

    S, F, D = 4, 1200, 256
    rng = np.random.default_rng(5 if kind == "prefix" else 6)
    d = _pm1_with_ties(rng, S, F, D)
    if kind == "prefix":
        v = np.arange(F)[None] < np.array([132, 0, 480, F])[:, None]
    else:
        v = rng.random((S, F)) > 0.3
        v &= np.arange(F)[None] < np.array([700, 300, 1000, 1150])[:, None]
    pairs = np.array([(a, b) for a in range(S) for b in range(S) if a != b], np.int32)
    dt, vt, pt = (torch.from_numpy(x).cuda() for x in (d, v, pairs))
    out_k = K.two_nn_batch_fused(dt.to(getattr(torch, route)), vt, pt)
    out_p = two_nn_batch(dt, vt, pt)
    torch.cuda.synchronize()
    _assert_extent_contract(out_k, out_p, vt, pt)


@pytest.mark.gpu
def test_k1_bf16_route_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K

    v = torch.ones((2, 64), dtype=torch.bool, device="cuda")
    p = torch.tensor([[0, 1]], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        K.two_nn_batch_fused(torch.zeros((2, 64, 128), dtype=torch.float16, device="cuda"), v, p)
    with pytest.raises(ValueError):
        K.two_nn_batch_fused(torch.zeros((2, 64, 576), dtype=torch.bfloat16, device="cuda"), v, p)
    with pytest.raises(ValueError):  # K1x keeps float32 only
        K.two_nn_exact_batch(torch.zeros((2, 64, 128), dtype=torch.bfloat16, device="cuda"), v, p)


def _k1x_valid(rng, layout, S, F):
    """K1x's slot layouts: "random" ~90% valid, scattered; "sift" SIFT's
    primaries' prefix plus sparse secondaries from k_sel = F / 2 (not a
    valid prefix); "empty" random with one shot that has no valid slot."""
    k = np.arange(F)[None]
    if layout == "sift":
        n = rng.integers(int(0.55 * (F // 2)), int(0.75 * (F // 2)), size=(S, 1))
        return (k < n) | ((k >= F // 2) & (k - F // 2 < n) & (rng.random((S, F)) < 0.15))
    v = rng.random((S, F)) > 0.1
    if layout == "empty":
        v[1] = False
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("S,F,D,layout", [(3, 200, 128, "random"), (2, 1000, 96, "random"),
                                          (2, 333, 256, "random"), (4, 64, 7, "random"),
                                          (3, 65, 128, "random"), (3, 1000, 128, "sift"),
                                          (3, 300, 7, "sift"), (3, 300, 96, "empty")])
def test_k1x_bit_equal_to_plain_and_k1_on_integers(S, F, D, layout):
    """Integer descriptors with ties over every ordered pair, (s, s)
    included, under K1's extent contract against the plain version and
    against K1: bit-equal at every valid query, best^2 = BIG at every
    invalid one (K1x sweeps only valid slots), equal ratio-test masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch, two_nn_exact

    rng = np.random.default_rng(S * 1000 + F + D + 1)
    d = rng.integers(0, 256, size=(S, F, D)).astype(np.float32)
    for s in range(S):  # duplicated rows: exact ties
        d[s, rng.integers(0, F, F // 8)] = d[s, rng.integers(0, F, F // 8)]
    v = _k1x_valid(rng, layout, S, F)
    pairs = np.array([(a, b) for a in range(S) for b in range(S)], np.int32)
    dt, vt, pt = (torch.from_numpy(x).cuda() for x in (d, v, pairs))
    before = K.two_nn_exact_batch.launches
    out_x = K.two_nn_exact_batch(dt, vt, pt)
    out_p = two_nn_batch(dt, vt, pt, nn=two_nn_exact)
    out_1 = K.two_nn_batch_fused(dt, vt, pt)
    torch.cuda.synchronize()
    assert K.two_nn_exact_batch.launches == before + 1
    _assert_extent_contract(out_x, out_p, vt, pt)
    _assert_extent_contract(out_x, out_1, vt, pt)
    vq = vt[pt[:, 0].long()]
    assert bool((out_x[2][~vq] == 3.0e38).all() and (out_x[0][~vq] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["random", "sift"])
def test_k1x_continuous_within_tolerance(layout):
    """Continuous descriptors: at every valid query best^2 and second^2
    within 1e-5 (|q|^2 + |t|^2) of the plain version, idx equal wherever
    best and second lie farther apart than that."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch, two_nn_exact

    S, F, D = 3, 700, 128
    rng = np.random.default_rng(7)
    base = np.abs(rng.normal(size=(F, D))).astype(np.float32)
    d = np.abs(np.stack([base + rng.normal(size=(F, D)).astype(np.float32) * (0.1 + 0.05 * s)
                         for s in range(S)])).astype(np.float32)
    v = _k1x_valid(rng, layout, S, F)
    pairs = np.array([(0, 1), (1, 2), (2, 0)], np.int32)
    dt, vt, pt = (torch.from_numpy(x).cuda() for x in (d, v, pairs))
    ix, bx, sx = K.two_nn_exact_batch(dt, vt, pt)
    ip, bp, sp = two_nn_batch(dt, vt, pt, nn=two_nn_exact)
    n = (dt * dt).sum(-1)
    pq, ptt = pt[:, 0].long(), pt[:, 1].long()
    vq = vt[pq]
    tol_b = 1e-5 * (n[pq] + torch.gather(n[ptt], 1, ip.long()))
    tol_s = 1e-5 * (n[pq] + n[ptt].amax(dim=1, keepdim=True))
    assert bool(((bx - bp).abs() <= tol_b)[vq].all())
    assert bool(((sx - sp).abs() <= tol_s)[vq].all())
    assert bool((bx[~vq] == 3.0e38).all())
    apart = vq & ((sp - bp) > tol_b + tol_s)
    assert int(apart.sum()) > 0.9 * int(vq.sum())
    assert torch.equal(ix[apart], ip[apart])


@pytest.mark.gpu
def test_k1x_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K

    d = torch.zeros((2, 64, 128), device="cuda")
    v = torch.ones((2, 64), dtype=torch.bool, device="cuda")
    p = torch.tensor([[0, 1]], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        K.two_nn_exact_batch(d.double(), v, p)
    with pytest.raises(ValueError):
        K.two_nn_exact_batch(d, v, p.long())
    with pytest.raises(ValueError):
        K.two_nn_exact_batch(d, v.cpu(), p)
    with pytest.raises(ValueError):  # the resident query rows cap the width
        K.two_nn_exact_batch(torch.zeros((2, 64, 320), device="cuda"), v, p)
    out = K.two_nn_exact_batch(d, v, p[:0])  # P = 0: nothing launched
    assert all(x.shape == (0, 64) for x in out)


def _sgm_inputs(h, w, d, seed, offset=0, device="cpu", dtype=torch.float32):
    """Random costs (H, W, D) in [0, 1) on `device`; `offset` > 0 gives a
    contiguous view that starts `offset` elements into its storage, so its
    rows sit off the 16-byte grid. The values do not depend on `offset`."""
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.random(h * w * d, dtype=np.float32)).to(dtype)
    flat = torch.empty(h * w * d + offset, dtype=dtype, device=device)
    flat[offset:] = vals.to(device)
    return flat[offset:].view(h, w, d)


# line counts that are not multiples of a block's two warps, S below the
# ring depth of 4, D = 1, 37 and 256, odd H x W, rows off the 16-byte grid
SGM_SHAPES = [(13, 21, 37, 0), (40, 33, 96, 0), (1, 50, 1, 0), (17, 9, 256, 0),
              (64, 70, 33, 0), (3, 5, 37, 0), (7, 2, 1, 0), (1, 1, 96, 0), (5, 3, 256, 0),
              (11, 13, 1, 0), (9, 15, 96, 1), (6, 7, 37, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,D,offset", SGM_SHAPES)
def test_k2a_bit_equal_to_plain(H, W, D, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.mvs.sgm import sgm_bidir_plain
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    v = _sgm_inputs(H, W, D, H * W + D)
    vc = _sgm_inputs(H, W, D, H * W + D, offset, "cuda")
    for axis in (0, 1):
        before = K2.sgm_bidir.launches
        out = K2.sgm_bidir(vc, 0.03, 0.3, axis=axis)
        torch.cuda.synchronize()
        assert K2.sgm_bidir.launches == before + 1
        assert torch.equal(out, sgm_bidir_plain(vc, 0.03, 0.3, axis))
        assert torch.equal(out.cpu(), sgm_bidir_plain(v, 0.03, 0.3, axis))


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,D,offset", SGM_SHAPES)
def test_k2b_bit_equal_to_plain(H, W, D, offset):
    """The staged route (one horizontal-pair launch, then one launch for
    each vertical direction) against its plain version and against four
    sequential directions of sgm_dir_acc on a zeroed accumulator, the
    route it replaces."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.mvs.sgm import sgm_dir_acc_plain, sgm_hpair_plain, staged_sum
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    v = _sgm_inputs(H, W, D, H + W * D)
    vc = _sgm_inputs(H, W, D, H + W * D, offset, "cuda")
    before = (K2.sgm_hpair.launches, K2.sgm_dir_acc.launches)
    out = K2.sgm_staged_hwd(vc, 0.03, 0.3)
    torch.cuda.synchronize()
    assert (K2.sgm_hpair.launches, K2.sgm_dir_acc.launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(out, staged_sum(vc, 0.03, 0.3, sgm_hpair_plain, sgm_dir_acc_plain))
    assert torch.equal(out.cpu(), staged_sum(v, 0.03, 0.3, sgm_hpair_plain, sgm_dir_acc_plain))
    cv = vc.to(torch.bfloat16)
    acc = torch.zeros_like(vc)
    for axis, reverse in ((1, False), (1, True), (0, False), (0, True)):
        K2.sgm_dir_acc(cv, acc, 0.03, 0.3, axis=axis, reverse=reverse)
    torch.cuda.synchronize()
    assert torch.equal(out, acc)


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,D,offset", SGM_SHAPES)
def test_k2b_entries_bit_equal_to_plain(H, W, D, offset):
    """Each K2b entry alone: the horizontal pair's sum and bf16 copy, and
    one direction added in place to a non-zero accumulator."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.mvs.sgm import sgm_dir_acc_plain, sgm_hpair_plain
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    vc = _sgm_inputs(H, W, D, 7 * H + D, offset, "cuda")
    acc_k, cv_k = K2.sgm_hpair(vc, 0.03, 0.3)
    acc_p, cv_p = sgm_hpair_plain(vc, 0.03, 0.3)
    torch.cuda.synchronize()
    assert cv_k.dtype == torch.bfloat16 and torch.equal(cv_k, cv_p)
    assert torch.equal(acc_k, acc_p)
    # a bf16 cost whose rows sit off the grid too
    cv_k = _sgm_inputs(H, W, D, 7 * H + D, offset, "cuda", torch.bfloat16)
    start = _sgm_inputs(H, W, D, 11 * W + D, 0, "cuda")
    for axis in (0, 1):
        for reverse in (False, True):
            a_k, a_p = start.clone(), start.clone()
            assert K2.sgm_dir_acc(cv_k, a_k, 0.03, 0.3, axis=axis, reverse=reverse) is a_k
            sgm_dir_acc_plain(cv_k, a_p, 0.03, 0.3, axis=axis, reverse=reverse)
            torch.cuda.synchronize()
            assert torch.equal(a_k, a_p), (axis, reverse)


@pytest.mark.gpu
def test_sgm_kernels_reject_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    v = torch.rand((8, 9, 16), device="cuda")
    with pytest.raises(ValueError):
        K2.sgm_bidir(v.double(), 0.03, 0.3, axis=0)
    with pytest.raises(ValueError):
        K2.sgm_bidir(v.transpose(0, 1), 0.03, 0.3, axis=0)
    with pytest.raises(ValueError):
        K2.sgm_bidir(torch.rand((4, 4, 300), device="cuda"), 0.03, 0.3, axis=0)
    with pytest.raises(ValueError):
        K2.sgm_dir_acc(v, torch.zeros_like(v), 0.03, 0.3, axis=1, reverse=False)  # f32 cost
    with pytest.raises(ValueError):
        K2.sgm_dir_acc(v.bfloat16(), torch.zeros((8, 9, 15), device="cuda"), 0.03, 0.3,
                       axis=1, reverse=False)
    with pytest.raises(ValueError):
        K2.sgm_hpair(v.bfloat16(), 0.03, 0.3)  # the pair reads the f32 cost
    with pytest.raises(ValueError):
        K2.sgm_hpair(v.transpose(0, 1), 0.03, 0.3)


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,W,r,maxd", [(6, 37, 300, 3, 256), (1, 20, 129, 2, 140),
                                          (3, 9, 64, 1, 64), (2, 16, 50, 4, 60)])
def test_k3_bit_equal_to_plain(C, H, W, r, maxd):
    """Random candidates over [0, maxd] (taps left of the image read 0),
    some integral (frac = 0) and some past maxd, an invalid band and a
    random scatter of invalid pixels in in_n."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.mvs.patchmatch import pm_score_rect_plain
    from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import window_stats
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3

    rng = np.random.default_rng(C * 1000 + W + r)
    ref, nbr = rng.random((2, H, W), dtype=np.float32)
    in_n = rng.random((H, W)) > 0.05
    in_n[:, : W // 10] = False
    cands = (rng.random((C, H, W)) * maxd).astype(np.float32)
    cands[0, :, :5] = np.floor(cands[0, :, :5])
    cands[-1, 0] = maxd + 7.5
    ref_t = torch.from_numpy(ref)
    r_mean, r_var = window_stats(ref_t, r)
    cpu = [torch.from_numpy(cands), ref_t, torch.from_numpy(nbr), torch.from_numpy(in_n),
           r_mean.contiguous(), r_var.contiguous()]
    dev = [x.cuda() for x in cpu]
    before = K3.pm_score_rect.launches
    out = K3.pm_score_rect(*dev, maxd=maxd, window_radius=r)
    torch.cuda.synchronize()
    assert K3.pm_score_rect.launches == before + 1
    assert out.shape == (C, H, W) and torch.isfinite(out).all()
    assert torch.equal(out, pm_score_rect_plain(*dev, maxd=maxd, window_radius=r))
    torch.testing.assert_close(out.cpu(), pm_score_rect_plain(*cpu, maxd=maxd, window_radius=r),
                               atol=1e-6, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("C,H,W,r,maxd,spread", [(6, 37, 300, 3, 256, 1.0), (1, 20, 129, 2, 140, 1.0),
                                                 (2, 16, 51, 4, 60, 1.0), (3, 11, 200, 3, 8, 20.0)])
def test_k3_parity_bit_equal_to_plain(parity, C, H, W, r, maxd, spread):
    """The parity form: active pixels bit-equal to the plain version's
    parity form, the others 1; odd widths; `spread` > 1 puts candidates far
    past maxd, so the blocks read their taps through L1 instead of shared
    memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.mvs.patchmatch import pm_score_rect_plain
    from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import window_stats
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3

    rng = np.random.default_rng(C * 1000 + W + r + parity)
    ref, nbr = rng.random((2, H, W), dtype=np.float32)
    in_n = rng.random((H, W)) > 0.05
    in_n[:, : W // 10] = False
    cands = (rng.random((C, H, W)) * maxd * spread).astype(np.float32)
    cands[0, :, :5] = np.floor(cands[0, :, :5])
    ref_t = torch.from_numpy(ref).cuda()
    r_mean, r_var = window_stats(ref_t, r)
    dev = [torch.from_numpy(cands).cuda(), ref_t, torch.from_numpy(nbr).cuda(),
           torch.from_numpy(in_n).cuda(), r_mean.contiguous(), r_var.contiguous()]
    before = K3.pm_score_rect.launches
    out = K3.pm_score_rect(*dev, maxd=maxd, window_radius=r, parity=parity)
    full = K3.pm_score_rect(*dev, maxd=maxd, window_radius=r)
    torch.cuda.synchronize()
    assert K3.pm_score_rect.launches == before + 2
    assert torch.equal(out, pm_score_rect_plain(*dev, maxd=maxd, window_radius=r, parity=parity))
    assert torch.equal(full, pm_score_rect_plain(*dev, maxd=maxd, window_radius=r))
    ys, xs = np.mgrid[:H, :W]
    act = torch.from_numpy((ys + xs) % 2 == parity).cuda()
    assert torch.equal(out[:, act], full[:, act]) and bool((out[:, ~act] == 1).all())


@pytest.mark.gpu
def test_k3_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3

    c = torch.rand((2, 8, 16), device="cuda")
    m = torch.rand((8, 16), device="cuda")
    ok = torch.ones((8, 16), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        K3.pm_score_rect(c.double(), m, m, ok, m, m, maxd=16)
    with pytest.raises(ValueError):
        K3.pm_score_rect(c, m, m, ok.float(), m, m, maxd=16)
    with pytest.raises(ValueError):
        K3.pm_score_rect(c, m, m.t().contiguous().t(), ok, m, m, maxd=16)
    with pytest.raises(ValueError):
        K3.pm_score_rect(c, m, m, ok, m, m, maxd=16, window_radius=5)
    with pytest.raises(ValueError):
        K3.pm_score_rect(c, m, m, ok, m.cpu(), m, maxd=16)
    with pytest.raises(ValueError):
        K3.pm_score_rect(c, m, m, ok, m, m, maxd=16, parity=2)


@pytest.mark.gpu
def test_kernels_launch_on_their_inputs_card():
    """Every kernel on tensors of cuda:1 while cuda:0 is the current card:
    each wrapper launches under its inputs' card and that card's stream,
    and the outputs, read after synchronising cuda:1 alone, equal the plain
    versions on the same tensors (K1 fp32 and bf16 and K2a, K2b, K3 bit for
    bit; K1x under K1's extent contract, bit-equal at valid queries on
    integers)."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA cards, found {torch.cuda.device_count()}")
    from sfm_mvs_pipeline_tpu_torch.mvs.patchmatch import pm_score_rect_plain
    from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import window_stats
    from sfm_mvs_pipeline_tpu_torch.mvs.sgm import (
        sgm_bidir_plain,
        sgm_dir_acc_plain,
        sgm_hpair_plain,
        staged_sum,
    )
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2
    from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch, two_nn_exact

    card = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(11)
    S, F, D = 3, 300, 128
    d = rng.integers(0, 256, size=(S, F, D)).astype(np.float32)
    for s in range(S):  # duplicated rows: exact ties
        d[s, rng.integers(0, F, F // 8)] = d[s, rng.integers(0, F, F // 8)]
    v = rng.random((S, F)) > 0.1
    v[:, -1] = True
    pairs = np.array([(a, b) for a in range(S) for b in range(S) if a != b], np.int32)
    dt, vt, pt = (torch.from_numpy(x).to(card) for x in (d, v, pairs))
    pm1 = torch.from_numpy(_pm1_with_ties(rng, S, F, 256)).to(card)
    cost = _sgm_inputs(40, 33, 96, 5, device=card)
    C, H, W, r, maxd = 4, 37, 200, 3, 120
    ref = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(card)
    nbr = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(card)
    in_n = torch.from_numpy(rng.random((H, W)) > 0.05).to(card)
    cands = torch.from_numpy((rng.random((C, H, W)) * maxd).astype(np.float32)).to(card)
    r_mean, r_var = (x.contiguous() for x in window_stats(ref, r))
    torch.cuda.synchronize(card)

    before = {k: k.launches for k in (K.two_nn_batch_fused, K.two_nn_exact_batch,
                                      K2.sgm_bidir, K2.sgm_hpair, K2.sgm_dir_acc,
                                      K3.pm_score_rect)}
    out = {
        "k1": K.two_nn_batch_fused(dt, vt, pt),
        "k1_bf16": K.two_nn_batch_fused(pm1.to(torch.bfloat16), vt, pt),
        "k1x": K.two_nn_exact_batch(dt, vt, pt),
        "k2a": [K2.sgm_bidir(cost, 0.03, 0.3, axis=a) for a in (0, 1)],
        "k2b": K2.sgm_staged_hwd(cost, 0.03, 0.3),
        "k3": [K3.pm_score_rect(cands, ref, nbr, in_n, r_mean, r_var, maxd=maxd,
                                window_radius=r, parity=p) for p in (None, 0)],
    }
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(card)
    calls = {"two_nn_batch_fused": 2, "sgm_bidir": 2, "sgm_dir_acc": 2, "pm_score_rect": 2}
    assert all(k.launches == n + calls.get(k.__name__, 1) for k, n in before.items())
    plain = two_nn_batch(dt, vt, pt)
    assert all(a.device == card and torch.equal(a, b) for a, b in zip(out["k1"], plain))
    assert all(torch.equal(a, b) for a, b in zip(out["k1_bf16"], two_nn_batch(pm1, vt, pt)))
    _assert_extent_contract(out["k1x"], two_nn_batch(dt, vt, pt, nn=two_nn_exact), vt, pt)
    for a, o in zip((0, 1), out["k2a"]):
        assert torch.equal(o, sgm_bidir_plain(cost, 0.03, 0.3, a))
    assert torch.equal(out["k2b"], staged_sum(cost, 0.03, 0.3, sgm_hpair_plain,
                                              sgm_dir_acc_plain))
    for p, o in zip((None, 0), out["k3"]):
        assert torch.equal(o, pm_score_rect_plain(cands, ref, nbr, in_n, r_mean, r_var, maxd,
                                                  r, parity=p))
