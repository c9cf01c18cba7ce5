"""The port's exact mode (K1x's plain version, ops/matching.py::two_nn_exact,
and the wrapper two_nn_exact_batch) and FLANN routing against the JAX
package.

two_nn_exact is held against the JAX package's exact-mode Pallas kernel
itself, `_two_nn_kernel` through `_call_kernel(..., interpret=True)`, on
operands built as `two_nn_pallas(exact=True)` builds them on its TPU
(ops/pallas/match_kernel.py:420-436). Inputs come from numpy seeds.

Tolerances:
  * integer descriptors (the port's SIFT: 0..255): bit-equal. The lo parts
    are 0 and every product and partial sum is an integer below 2^24, so
    the order of the fp32 sums cannot matter;
  * continuous descriptors: |d best^2|, |d second^2| <= 1e-5 (|q|^2 + |t|^2).
    The split's products are exact in fp32 on both sides; only the order
    and rounding of the fp32 sums of 3D products differ (~D ulps of the
    largest partial sum, far below 1e-5 of the norms). idx is equal
    wherever best and second lie farther apart than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu.ops import matching as JM
from sfm_mvs_pipeline_tpu.ops.pallas import match_kernel as JK
from sfm_mvs_pipeline_tpu_torch.ops import matching as TM
from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as TK

torch.set_num_threads(2)


def _descs(rng, kind, shape):
    """Integer descriptors with duplicated rows (exact ties), or continuous
    ones made like tests/test_torch_matching.py's so that the distances do
    not cancel against the norms."""
    if kind == "int":
        d = rng.integers(0, 256, size=shape).astype(np.float32)
        src = rng.integers(0, shape[-2], size=shape[-2] // 8)
        dst = rng.integers(0, shape[-2], size=shape[-2] // 8)
        d[..., dst, :] = d[..., src, :]
        return d
    base = np.abs(rng.normal(size=shape[-2:])).astype(np.float32)
    return np.abs(base + rng.normal(size=shape).astype(np.float32) * 0.3).astype(np.float32)


def _jax_exact_kernel(q, t, vq, vt):
    """two_nn_pallas(exact=True)'s TPU branch (:419-444) with the kernel
    run in interpret mode: (idx, best^2, second^2)."""
    fq, d = q.shape
    ft = t.shape[0]
    fq_p = -(-fq // JK.TILE_Q) * JK.TILE_Q
    ft_p = -(-ft // JK.TILE_T) * JK.TILE_T
    d_p = -(-d // 128) * 128
    qf = JK._pad_to(JK._pad_to(jnp.asarray(q), fq_p, 0), d_p, 1)
    tf = JK._pad_to(JK._pad_to(jnp.asarray(t), ft_p, 0), d_p, 1)
    qn = jnp.sum(qf * qf, axis=1)
    tn = jnp.where(JK._pad_to(jnp.asarray(vt), ft_p, 0), jnp.sum(tf * tf, axis=1), JK._BIG)[None, :]
    q2 = qf * -2.0
    q_hi = q2.astype(jnp.bfloat16)
    q_lo = (q2 - q_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    t_hi = tf.astype(jnp.bfloat16)
    t_lo = (tf - t_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    a = jnp.concatenate([q_hi, q_lo, q_hi], axis=1)
    b = jnp.concatenate([t_hi, t_hi, t_lo], axis=1)
    best, second, idx = JK._call_kernel(a, b, tn, fq_p, ft_p, 3 * d_p,
                                        jax.lax.Precision.DEFAULT, True)
    l1, l2, gi = JK._collapse(best, second, idx)
    best_sq = jnp.where(jnp.asarray(vq), jnp.maximum(l1[:fq] + qn[:fq], 0.0), JK._BIG)
    second_sq = jnp.maximum(l2[:fq] + qn[:fq], 0.0)
    return tuple(np.asarray(x) for x in (jnp.clip(gi[:fq], 0, ft - 1), best_sq, second_sq))


@pytest.mark.parametrize("kind", ["int", "cont"])
def test_two_nn_exact_vs_jax_exact_kernel(rng, kind):
    """At (Fq, Ft, D) = (300, 500, 128). Integer: bit-equal best^2 and
    second^2, and idx equal wherever best < second (the Pallas kernel
    breaks an exact tie by lane, match_kernel.py:56-63, where the port
    takes the lowest index). Continuous: the module docstring's tolerance."""
    q = _descs(rng, kind, (300, 128))
    t = _descs(rng, kind, (500, 128))
    if kind == "int":
        q[:40] = t[100:140]  # queries with exact twins, so ties reach the top-2
    vq = rng.random(300) > 0.1
    vt = rng.random(500) > 0.1
    ji, jb, js = _jax_exact_kernel(q, t, vq, vt)
    ti, tb, ts = (x.numpy() for x in TM.two_nn_exact(*(torch.from_numpy(x) for x in (q, t, vq, vt))))
    if kind == "int":
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(ts, js)
        strict = jb < js
        assert (~strict).sum() > 0, "no ties reached the top-2"
        np.testing.assert_array_equal(ti[strict], ji[strict])
        return
    qn = (q.astype(np.float64) ** 2).sum(1)
    tn = (t.astype(np.float64) ** 2).sum(1)
    tol_b = 1e-5 * (qn + tn[ti])
    tol_s = 1e-5 * (qn + tn.max())
    assert np.all(np.abs(tb - jb)[vq] <= tol_b[vq])
    assert np.all(np.abs(ts - js) <= tol_s)
    apart = vq & ((js - jb) > tol_b + tol_s)
    assert apart.sum() > 0.9 * vq.sum()
    np.testing.assert_array_equal(ti[apart], ji[apart])
    # and both are near the float64 brute force
    d64 = ((q.astype(np.float64)[:, None] - t.astype(np.float64)[None]) ** 2).sum(-1)
    d64[:, ~vt] = np.inf
    np.testing.assert_array_equal(ti[apart], d64.argmin(1)[apart])


def test_exact_wrapper_on_cpu_is_the_plain_version(rng):
    """two_nn_exact_batch on CPU tensors takes two_nn_exact over the pair
    table (bit-equal); on integer descriptors it also equals K1's wrapper
    (the fp32 plain version) bit for bit, ties included."""
    S, F = 3, 150
    pairs = torch.tensor([(0, 1), (2, 0), (1, 2), (1, 1)], dtype=torch.int32)
    for kind in ("int", "cont"):
        d = torch.from_numpy(_descs(rng, kind, (S, F, 96)))
        v = torch.from_numpy(rng.random((S, F)) > 0.1)
        before = TK.two_nn_exact_batch.launches
        out = TK.two_nn_exact_batch(d, v, pairs)
        assert TK.two_nn_exact_batch.launches == before  # the plain version counts nothing
        for k, (a, b) in enumerate(pairs.tolist()):
            ref = TM.two_nn_exact(d[a], d[b], v[a], v[b])
            for x, y in zip(out, ref):
                assert torch.equal(x[k], y)
        if kind == "int":
            for x, y in zip(out, TK.two_nn_batch_fused(d, v, pairs)):
                assert torch.equal(x, y)


@pytest.mark.parametrize("D", [7, 128, 256])
def test_exact_operands_layout(rng, D):
    """The kernel's operands, built on the host side of the wrapper: A holds
    q2 = -2 q and B holds t, each split into bf16 hi + lo and laid out as
    EXACT_BK-wide chunks [hi_0 | lo_0 | hi_1 | lo_1 | ...], width 2 Dp with
    Dp = D padded to a multiple of EXACT_BK by zeros. The three products the
    kernel issues per chunk (hi.hi, lo.hi, hi.lo), summed over the chunks,
    are the plain version's three-term dot: bit-equal on integer descriptors
    (exact integers), within 1e-5 (|q|^2 + |t|^2) on continuous ones
    (another summation order, as in the module docstring)."""
    bk = TK.EXACT_BK
    dp = -(-D // bk) * bk
    for kind in ("int", "cont"):
        d = torch.from_numpy(_descs(rng, kind, (2, 40, D)))
        a, b = TK.exact_operands(d)
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape == (2, 40, 2 * dp)
        # (S, F, chunk, hi | lo, k) -> hi and lo of width Dp
        a_hi, a_lo, b_hi, b_lo = (x.float().unflatten(-1, (dp // bk, 2, bk))[..., h, :].flatten(-2)
                                  for x in (a, b) for h in (0, 1))
        q_hi, q_lo = TM.split_bf16(d[0] * -2.0)
        t_hi, t_lo = TM.split_bf16(d[1])
        for part, ref in ((a_hi[0], q_hi), (a_lo[0], q_lo), (b_hi[1], t_hi), (b_lo[1], t_lo)):
            assert torch.equal(part[:, :D], ref) and not part[:, D:].any()
        dot = sum(a_hi[0, :, c:c + bk] @ b_hi[1, :, c:c + bk].T
                  + a_lo[0, :, c:c + bk] @ b_hi[1, :, c:c + bk].T
                  + a_hi[0, :, c:c + bk] @ b_lo[1, :, c:c + bk].T for c in range(0, dp, bk))
        ref = q_hi @ t_hi.T + q_lo @ t_hi.T + q_hi @ t_lo.T
        if kind == "int":
            assert torch.equal(dot, ref) and torch.equal(ref, -2.0 * d[0] @ d[1].T)
        else:
            scale = (d[0] ** 2).sum(1)[:, None] + (d[1] ** 2).sum(1)[None]
            assert bool(((dot - ref).abs() <= 1e-5 * scale).all())


def _valid_layout(rng, layout, S, F):
    """Slot validity (S, F). "sift": SIFT's layout while 2 k_sel <= F
    (ops/sift.py::_describe_and_pool's place()): the primaries' prefix, then
    from k_sel = F / 2 sparse secondary orientations at their primary's
    offset. "random": ~90% valid, scattered. "empty": random with a shot
    that has no valid slot. "sparse": ~5% valid, so every count is below
    one 128-slot tile."""
    k = np.arange(F)[None]
    if layout == "sift":
        k_sel = F // 2
        n = rng.integers(int(0.55 * k_sel), int(0.75 * k_sel), size=(S, 1))
        sec = (k >= k_sel) & (k - k_sel < n) & (rng.random((S, F)) < 0.15)
        return (k < n) | sec
    v = rng.random((S, F)) > (0.95 if layout == "sparse" else 0.1)
    if layout == "empty":
        v[1] = False
    return v


def _compacted_plain(d, v, pairs):
    """K1x's path with the plain version standing in for the kernel:
    compact_slots, two_nn_exact over the compacted slots (a shot's first
    `count` valid), scatter_back."""
    perm, count = TK.compact_slots(v)
    dc = torch.gather(d, 1, perm[..., None].expand(-1, -1, d.shape[-1]))
    vc = torch.arange(d.shape[1])[None] < count[:, None]
    return TK.scatter_back(*TM.two_nn_batch(dc, vc, pairs, nn=TM.two_nn_exact), perm, pairs, v)


@pytest.mark.parametrize("kind,layout", [("int", "sift"), ("int", "random"), ("int", "empty"),
                                         ("int", "sparse"), ("cont", "sift")])
def test_compacted_slots_hold_the_extent_contract(rng, kind, layout):
    """compact_slots puts each shot's valid slots first in slot order, and
    the compacted path holds K1's extent contract against
    two_nn_batch(nn=two_nn_exact) over every ordered pair, (s, s) included:
    at every valid query bit-equal on integer descriptors (ties included:
    the stable compaction keeps the lowest-slot rule), within the module
    docstring's tolerance on continuous ones; best^2 = second^2 = BIG and
    idx = 0 at every invalid query; equal ratio-test masks."""
    S, F = 3, 300
    d = torch.from_numpy(_descs(rng, kind, (S, F, 128)))
    v = torch.from_numpy(_valid_layout(rng, layout, S, F))
    pairs = torch.tensor([(a, b) for a in range(S) for b in range(S)], dtype=torch.int32)
    perm, count = TK.compact_slots(v)
    assert count.dtype == torch.int32 and torch.equal(count.long(), v.sum(1))
    for s in range(S):
        n = int(count[s])
        assert torch.equal(perm[s, :n], torch.nonzero(v[s])[:, 0])
        assert torch.equal(perm[s, n:], torch.nonzero(~v[s])[:, 0])
    ix, bx, sx = _compacted_plain(d, v, pairs)
    ip, bp, sp = TM.two_nn_batch(d, v, pairs, nn=TM.two_nn_exact)
    vq = v[pairs[:, 0].long()]
    assert bool((bx[~vq] == TM.BIG).all() and (sx[~vq] == TM.BIG).all() and (ix[~vq] == 0).all())
    if kind == "int":
        for x, y in ((ix, ip), (bx, bp), (sx, sp)):
            assert torch.equal(x[vq], y[vq])
        if layout != "sparse":
            assert int(((bp == sp) & vq).sum()) > 0, "no ties reached the top-2"
    else:
        n = (d.double() ** 2).sum(-1)
        pq, pt = pairs[:, 0].long(), pairs[:, 1].long()
        tol_b = 1e-5 * (n[pq] + torch.gather(n[pt], 1, ip.long()))
        tol_s = 1e-5 * (n[pq] + n[pt].amax(dim=1, keepdim=True))
        assert bool(((bx - bp).abs() <= tol_b)[vq].all() and ((sx - sp).abs() <= tol_s)[vq].all())
        apart = vq & ((sp - bp) > tol_b + tol_s)
        assert int(apart.sum()) > 0.9 * int(vq.sum())
        assert torch.equal(ix[apart], ip[apart])
    if kind == "int" or layout != "sift":
        assert torch.equal(TM.ratio_test_mask(bx, sx, vq), TM.ratio_test_mask(bp, sp, vq))


def test_compacted_slots_vs_jax_exact_kernel(rng):
    """The compacted path on the SIFT-like layout against the JAX package's
    exact-mode Pallas kernel in interpret mode, on integer descriptors:
    best^2 and second^2 bit-equal at every valid query, idx equal wherever
    best < second (the Pallas kernel breaks exact ties by lane)."""
    S, F = 2, 256
    d = _descs(rng, "int", (S, F, 128))
    v = _valid_layout(rng, "sift", S, F)
    pairs = torch.tensor([(0, 1), (1, 0)], dtype=torch.int32)
    ix, bx, sx = (x.numpy() for x in _compacted_plain(torch.from_numpy(d), torch.from_numpy(v),
                                                      pairs))
    for k, (a, b) in enumerate(pairs.tolist()):
        ji, jb, js = _jax_exact_kernel(d[a], d[b], v[a], v[b])
        vq = v[a]
        np.testing.assert_array_equal(bx[k][vq], jb[vq])
        np.testing.assert_array_equal(sx[k][vq], js[vq])
        strict = vq & (jb < js)
        np.testing.assert_array_equal(ix[k][strict], ji[strict])


def test_match_pairs_batch_exact_equals_fast_on_integer_descriptors(rng):
    """match_pairs_batch(exact=True) (K1x's route) and exact=False (K1's)
    give identical idx, mask and distance tables on integer descriptors,
    ties and the distinct filter included."""
    d = torch.from_numpy(_descs(rng, "int", (4, 200, 128)))
    v = torch.from_numpy(rng.random((4, 200)) > 0.05)
    pairs = torch.tensor([(a, b) for a in range(4) for b in range(a + 1, 4)], dtype=torch.int32)
    for distinct in (False, True):
        fast = TM.match_pairs_batch(d, v, pairs, distinct=distinct, with_distance=True)
        exact = TM.match_pairs_batch(d, v, pairs, distinct=distinct, with_distance=True, exact=True)
        for x, y in zip(fast, exact):
            assert torch.equal(x, y)


def test_flann_is_the_exact_brute_force(rng):
    """method="flann" in the port equals the JAX package's
    match_pairs_batch(method="bf"): on its TPU the JAX package rewrites
    flann to bf and runs the exact kernel (ops/matching.py:182-190,
    :249-251), and the port takes that branch on every device. (Off its TPU
    the JAX package runs the approximate shortlist two_nn_approx, which the
    port does not have, so that is not the comparison.) Same tolerance as
    tests/test_torch_matching.py's float case: equal masks and matched
    indices, distances to rtol 1e-5."""
    S, F = 3, 256
    base = np.abs(rng.normal(size=(F, 128))).astype(np.float32)
    d = np.abs(np.stack([base + rng.normal(size=(F, 128)).astype(np.float32) * s
                         for s in (0.0, 0.25, 0.35)])).astype(np.float32)
    v = rng.random((S, F)) > 0.05
    pairs = np.array([(0, 1), (0, 2), (1, 2)], np.int32)
    bi_j, m_j, dist_j = (np.asarray(x) for x in JM.match_pairs_batch(
        jnp.asarray(d), jnp.asarray(v), jnp.asarray(pairs), method="bf", backend="jnp",
        with_distance=True))
    bi_t, m_t, dist_t = (x.numpy() for x in TM.match_pairs_batch(
        torch.from_numpy(d), torch.from_numpy(v), torch.from_numpy(pairs), method="flann",
        with_distance=True))
    assert m_j.sum() > 100
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(bi_t[m_j], bi_j[m_j])
    np.testing.assert_allclose(dist_t[m_j], dist_j[m_j], rtol=1e-5)
    bi_b, m_b, dist_b = TM.match_pairs_batch(torch.from_numpy(d), torch.from_numpy(v),
                                             torch.from_numpy(pairs), with_distance=True)
    assert np.array_equal(bi_b.numpy(), bi_t) and np.array_equal(m_b.numpy(), m_t)
    with pytest.raises(ValueError):
        TM.match_pairs_batch(torch.from_numpy(d), torch.from_numpy(v), torch.from_numpy(pairs),
                             method="kdtree")


def test_binary_descriptors_match_as_hamming(rng):
    """ORB's packed bits expanded to +-1 at D = 256 through the port's
    matcher equal the JAX package's matcher on the same expansion (every dot
    product is an integer, so bit-equal), and |a - b|^2 = 4 hamming."""
    packed = rng.integers(0, 256, size=(3, 120, 32)).astype(np.uint8)
    packed[1, :30] = packed[0, 10:40]  # exact twins: distance 0
    e_t = TM.expand_binary_descriptors(torch.from_numpy(packed))
    e_j = np.asarray(JM.expand_binary_descriptors(jnp.asarray(packed)))
    np.testing.assert_array_equal(e_t.numpy(), e_j)
    v = rng.random((3, 120)) > 0.05
    pairs = np.array([(0, 1), (1, 2), (2, 0)], np.int32)
    bi_t, m_t, dist_t = (x.numpy() for x in TM.match_pairs_batch(
        e_t, torch.from_numpy(v), torch.from_numpy(pairs), with_distance=True))
    bi_j, m_j, dist_j = (np.asarray(x) for x in JM.match_pairs_batch(
        jnp.asarray(e_j), jnp.asarray(v), jnp.asarray(pairs), backend="jnp", with_distance=True))
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(bi_t[m_t], bi_j[m_j])
    np.testing.assert_array_equal(dist_t[m_t], dist_j[m_j])
    ham = np.unpackbits(packed[0][:, None] ^ packed[1][None], axis=-1).sum(-1)
    best = ham[np.arange(120), bi_t[0]]
    # the returned distance is the float32 sqrt of 4 * hamming
    np.testing.assert_allclose(dist_t[0][m_t[0]].astype(np.float64) ** 2, 4.0 * best[m_t[0]],
                               rtol=1e-6)
