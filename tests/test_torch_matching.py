"""Parity of the port's matcher module (ops/matching.py + kernel wrapper K1)
with the JAX package's matcher.

On the CPU the K1 wrapper runs its plain PyTorch version (the CUDA kernel
itself is compared with that version on the card by tests/test_torch_kernels.py
and chip_smoke.py). Inputs come from numpy seeds and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu.ops import matching as JM
from sfm_mvs_pipeline_tpu.ops.pallas.match_kernel import two_nn_batch_fused as j_fused
from sfm_mvs_pipeline_tpu_torch.ops import matching as TM
from sfm_mvs_pipeline_tpu_torch.ops.kernels.match_kernel import (
    two_nn_batch_fused as t_fused,
)

torch.set_num_threads(2)


def _int_descs_with_ties(rng, S, F, D=128):
    """Integer-valued descriptors (exact in fp32: 128 * 255^2 < 2^24) with
    duplicated rows, so exact distance ties occur."""
    d = rng.integers(0, 256, size=(S, F, D)).astype(np.float32)
    for s in range(S):
        src = rng.integers(0, F, size=F // 8)
        dst = rng.integers(0, F, size=F // 8)
        d[s, dst] = d[s, src]
    valid = rng.random((S, F)) > 0.1
    return d, valid


def test_two_nn_bit_equal_to_jnp_on_integer_ties(rng):
    """Integer descriptors with injected ties: idx, best^2 and second^2
    are bit-equal to two_nn_jnp (tolerance 0: all arithmetic is exact and
    both take the lowest target index on ties)."""
    d, v = _int_descs_with_ties(rng, 2, 300)
    bi_j, b_j, s_j = JM.two_nn_jnp(jnp.asarray(d[0]), jnp.asarray(d[1]), jnp.asarray(v[0]), jnp.asarray(v[1]))
    bi_t, b_t, s_t = TM.two_nn(torch.from_numpy(d[0]), torch.from_numpy(d[1]), torch.from_numpy(v[0]), torch.from_numpy(v[1]))
    assert int((np.asarray(b_j) == np.asarray(s_j)).sum()) > 0, "no ties injected"
    np.testing.assert_array_equal(bi_t.numpy(), np.asarray(bi_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_batched_wrapper_vs_jnp_and_pallas_interpret(rng):
    """The port's batched path (the K1 wrapper, plain version on CPU) against
    two_nn_jnp pair by pair (bit-equal, as above) and against the Pallas
    kernel in interpret mode: best^2 / second^2 bit-equal, and idx equal
    wherever the Lowe test keeps the match — the Pallas contract picks the
    lowest LANE on exact ties, not the lowest index
    (match_kernel.py:56-63), and a tie never survives the ratio test."""
    S, F = 3, 200
    d, v = _int_descs_with_ties(rng, S, F)
    pairs = np.array([(0, 1), (2, 0), (1, 2)], np.int32)
    bi_t, b_t, s_t = t_fused(torch.from_numpy(d), torch.from_numpy(v), torch.from_numpy(pairs))
    bi_f, b_f, s_f = (np.asarray(x) for x in j_fused(jnp.asarray(d), jnp.asarray(v), jnp.asarray(pairs), interpret=True))
    np.testing.assert_array_equal(b_t.numpy(), b_f)
    np.testing.assert_array_equal(s_t.numpy(), s_f)
    for k, (a, b) in enumerate(pairs):
        bi_j, b_j, s_j = (np.asarray(x) for x in JM.two_nn_jnp(
            jnp.asarray(d[a]), jnp.asarray(d[b]), jnp.asarray(v[a]), jnp.asarray(v[b])))
        np.testing.assert_array_equal(bi_t[k].numpy(), bi_j)
        np.testing.assert_array_equal(b_t[k].numpy(), b_j)
        np.testing.assert_array_equal(s_t[k].numpy(), s_j)
        m = np.asarray(JM.ratio_test_mask(b_f[k], s_f[k], v[a]))
        np.testing.assert_array_equal(bi_t[k].numpy()[m], bi_f[k][m])


@pytest.mark.parametrize("distinct", [False, True])
def test_match_pairs_batch_float_descriptors(rng, distinct):
    """Random float descriptors: distances agree to rtol 1e-5 (fp32 sums
    taken in another order; the noise keeps the distances comparable to
    the norms, so |q|^2 + |t|^2 - 2 q.t does not cancel) and the post-ratio
    masks and matched indices are equal."""
    S, F = 3, 256
    base = np.abs(rng.normal(size=(F, 128))).astype(np.float32)
    d = np.stack([base + rng.normal(size=(F, 128)).astype(np.float32) * s for s in (0.0, 0.25, 0.35)])
    d = np.abs(d).astype(np.float32)
    v = rng.random((S, F)) > 0.05
    pairs = np.array([(0, 1), (0, 2), (1, 2)], np.int32)
    bi_j, m_j, dist_j = (np.asarray(x) for x in JM.match_pairs_batch(
        jnp.asarray(d), jnp.asarray(v), jnp.asarray(pairs), distinct=distinct,
        backend="jnp", with_distance=True))
    bi_t, m_t, dist_t = (x.numpy() for x in TM.match_pairs_batch(
        torch.from_numpy(d), torch.from_numpy(v), torch.from_numpy(pairs),
        distinct=distinct, with_distance=True))
    assert m_j.sum() > 100
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(bi_t[m_j], bi_j[m_j])
    np.testing.assert_allclose(dist_t[m_j], dist_j[m_j], rtol=1e-5)
    counts_t = TM.min_match_count_filter(torch.from_numpy(m_t), 20).numpy()
    np.testing.assert_array_equal(counts_t, np.asarray(JM.min_match_count_filter(jnp.asarray(m_j), 20)))
    for a, b in zip(TM.matches_to_numpy(bi_t, m_t), JM.matches_to_numpy(bi_j, m_j)):
        np.testing.assert_array_equal(a, b)


def test_ratio_test_and_distinct_filter(rng):
    """ratio_test_mask and distinct_filter are exact elementwise logic:
    equal results on the same inputs, including BIG (invalid) distances
    and batched rows."""
    best = rng.random((4, 64)).astype(np.float32) * 100
    second = best + rng.random((4, 64)).astype(np.float32) * 100
    best[0, :5] = 3.0e38
    vq = rng.random((4, 64)) > 0.2
    m_t = TM.ratio_test_mask(torch.from_numpy(best), torch.from_numpy(second), torch.from_numpy(vq))
    m_j = JM.ratio_test_mask(jnp.asarray(best), jnp.asarray(second), jnp.asarray(vq))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    idx = rng.integers(0, 64, size=(4, 64)).astype(np.int32)
    d_t = TM.distinct_filter(torch.from_numpy(idx), m_t)
    for r in range(4):
        d_j = JM.distinct_filter(jnp.asarray(idx[r]), jnp.asarray(m_j[r]))
        np.testing.assert_array_equal(d_t[r].numpy(), np.asarray(d_j))
    # the JAX package's own example
    out = TM.distinct_filter(torch.tensor([2, 2, 1, 3]), torch.tensor([True, True, True, False]))
    assert out.tolist() == [False, False, True, False]


def test_match_pairs_batch_vs_match_pair_and_unported_options(rng):
    """One pair through the port's batched path equals the JAX package's
    single-pair match_pair; FLANN runs the same exact brute force (the JAX
    package's TPU branch), other backends refuse and unknown methods raise."""
    d, v = _int_descs_with_ties(rng, 2, 100)
    pair = torch.tensor([[0, 1]], dtype=torch.int32)
    bi, m = (x[0] for x in TM.match_pairs_batch(torch.from_numpy(d), torch.from_numpy(v), pair))
    bi_j, m_j = JM.match_pair(*(jnp.asarray(x) for x in (d[0], d[1], v[0], v[1])), backend="jnp")
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(bi.numpy()[m.numpy()], np.asarray(bi_j)[np.asarray(m_j)])
    bi_f, m_f = (x[0] for x in TM.match_pairs_batch(torch.from_numpy(d), torch.from_numpy(v), pair,
                                                    method="flann"))
    assert torch.equal(bi_f, bi) and torch.equal(m_f, m)
    with pytest.raises(NotImplementedError):
        TM.match_pairs_batch(torch.from_numpy(d), torch.from_numpy(v), pair, backend="jnp")
    with pytest.raises(ValueError):
        TM.match_pairs_batch(torch.from_numpy(d), torch.from_numpy(v), pair, method="lsh")
