"""K1's two routes and its valid-extent sweep, on the CPU.

The CUDA kernel K1 (ops/kernels/match_kernel.py) picks its route by the
descriptors' type: float32 on fp32 FMAs, bfloat16 (ORB's +-1 expansion) on
the tensor cores, and sweeps each shot only up to its valid extent. On the
CPU the wrapper runs the plain version, so these tests hold what the two
routes must agree on: the plain 2-NN of bf16 +-1 descriptors against its
float32 run and the JAX package's fused kernel (interpret mode), and the
extent helper against numpy. The kernels themselves are held to the plain
version on the card (tests/test_torch_kernels.py, chip_smoke.py).

Tolerances: 0. Every +-1 product and partial sum is an integer of at most
2 D, exact in float32 on every route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu.ops.pallas.match_kernel import two_nn_batch_fused as j_fused
from sfm_mvs_pipeline_tpu_torch.ops import matching as TM
from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K

torch.set_num_threads(2)


def _pm1_descs(rng, S, F, D=256):
    """+-1 descriptors: one random table with ~6% of its signs flipped in
    each shot (so the ratio test keeps matches), and duplicated rows, so
    distances tie exactly."""
    base = rng.integers(0, 2, size=(F, D)) * 2 - 1
    flips = np.where(rng.random((S, F, D)) < 0.06, -1, 1)
    d = (base[None] * flips).astype(np.float32)
    for s in range(S):
        d[s, rng.integers(0, F, F // 8)] = d[s, rng.integers(0, F, F // 8)]
    return d


def _valid(rng, kind, S, F):
    if kind == "holes":
        return rng.random((S, F)) > 0.1
    # ORB-like prefixes: top-k slots first, one shot with no valid slot
    ext = np.array([F * 3 // 4, 0, 37, F][:S])
    return np.arange(F)[None] < ext[:, None]


@pytest.mark.parametrize("kind", ["holes", "prefix"])
def test_plain_two_nn_on_bf16_pm1_equals_f32_and_jax(rng, kind):
    """The wrapper's CPU route on bf16 +-1 descriptors returns the float32
    run's idx, best^2 and second^2 bit for bit, and the JAX package's
    two_nn_batch_fused (interpret mode) on the same bits gives the same
    best^2 and second^2, and the same idx wherever the ratio test keeps a
    match (its tie rule picks the lowest lane, not the lowest index)."""
    S, F = 3, 200
    d = _pm1_descs(rng, S, F)
    v = _valid(rng, kind, S, F)
    pairs = np.array([(0, 1), (1, 2), (2, 0), (0, 2)], np.int32)
    d32, vt, pt = torch.from_numpy(d), torch.from_numpy(v), torch.from_numpy(pairs)
    out16 = K.two_nn_batch_fused(d32.to(torch.bfloat16), vt, pt)
    out32 = K.two_nn_batch_fused(d32, vt, pt)
    for a, b in zip(out16, out32):
        assert torch.equal(a, b)
    bi_j, b_j, s_j = (np.asarray(x) for x in j_fused(
        jnp.asarray(d, dtype=jnp.bfloat16), jnp.asarray(v), jnp.asarray(pairs), interpret=True))
    np.testing.assert_array_equal(out16[1].numpy(), b_j)
    np.testing.assert_array_equal(out16[2].numpy(), s_j)
    vq = v[pairs[:, 0]]
    m = np.asarray(TM.ratio_test_mask(out16[1], out16[2], torch.from_numpy(vq)))
    assert m.sum() > 0
    np.testing.assert_array_equal(out16[0].numpy()[m], bi_j[m])


@pytest.mark.parametrize("distinct", [False, True])
def test_match_pairs_batch_bf16_equals_f32(rng, distinct):
    """match_pairs_batch on bf16 +-1 descriptors, as sfm/incremental.py
    passes ORB's, returns the float32 tables and distances bit for bit."""
    d = _pm1_descs(rng, 3, 150)
    v = _valid(rng, "holes", 3, 150)
    pairs = torch.tensor([[0, 1], [0, 2], [1, 2]], dtype=torch.int32)
    d32, vt = torch.from_numpy(d), torch.from_numpy(v)
    out16 = TM.match_pairs_batch(d32.to(torch.bfloat16), vt, pairs, distinct=distinct,
                                 with_distance=True)
    out32 = TM.match_pairs_batch(d32, vt, pairs, distinct=distinct, with_distance=True)
    for a, b in zip(out16, out32):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["holes", "prefix", "none_valid", "all_valid", "last_only"])
def test_valid_extent_against_numpy(rng, case):
    """ext[s] = 1 + the last valid slot of shot s, 0 for a shot with none."""
    S, F = 5, 97
    v = {
        "holes": rng.random((S, F)) > 0.6,
        "prefix": np.arange(F)[None] < rng.integers(0, F + 1, size=S)[:, None],
        "none_valid": np.zeros((S, F), bool),
        "all_valid": np.ones((S, F), bool),
        "last_only": np.arange(F)[None].repeat(S, 0) == F - 1,
    }[case]
    want = np.array([np.nonzero(r)[0].max() + 1 if r.any() else 0 for r in v])
    got = K.valid_extent(torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_valid_extent_empty_capacity():
    got = K.valid_extent(torch.zeros((3, 0), dtype=torch.bool))
    assert got.dtype == torch.int32 and got.tolist() == [0, 0, 0]


def test_prepare_operands_bf16_norms_in_float32(rng):
    """bf16 descriptors are squared and summed in float32: the norms of
    the float32 copy, and BIG at invalid target slots."""
    d = rng.integers(-3, 4, size=(2, 40, 64)).astype(np.float32)  # exact in bf16
    v = rng.random((2, 40)) > 0.2
    qn16, tn16 = K.prepare_operands(torch.from_numpy(d).to(torch.bfloat16), torch.from_numpy(v))
    qn32, tn32 = K.prepare_operands(torch.from_numpy(d), torch.from_numpy(v))
    assert qn16.dtype == torch.float32 and torch.equal(qn16, qn32) and torch.equal(tn16, tn32)
    assert (tn16.numpy()[~v] == TM.BIG).all()
