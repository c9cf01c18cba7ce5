"""The port's ORB front end (ops/orb.py, the CLI's subpixel keypoints) and
its Hamming 2-NN matching (ops/matching.py::match_pairs_batch, K1's plain
version on the CPU, fed the bf16 +-1 expansion as sfm/incremental.py feeds
it) against tests/plain_orb.py, the plain float32 reference written from
the stated semantics, which imports neither jax, the JAX package nor the
port.

Images: three views at 320x240 of one seeded random texture (a coarse
cubic-upsampled noise plus a fine blurred one, rounded to 8 bits), each 24
px to the right of the last, capacity 1,024, which every view fills.
Tolerances are the reference's (`plain_orb.compare`), each with its reason
there: keypoints within 1e-3 px and angles within 1e-3 rad (float
rounding), responses within 1e-3 relative, every BRIEF bit equal unless
the reference's two samples lie within 1e-5 of each other,
keypoints selected by one side alone only at the selection's cut-off; the
2-NN's best target at every valid query and the ratio survivors exactly,
and the squared distances exactly (4 x Hamming, integers in float32). On
the CPU the two agree bit for bit; the same reference computed in bfloat16
fails the comparison.
"""

import ast
import os

import cv2
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu_torch.ops import matching as TM
from sfm_mvs_pipeline_tpu_torch.ops import orb as TO
from sfm_mvs_pipeline_tpu_torch.ops.pairs import make_pairs
from tests import plain_orb as R

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPACITY = 1024


def textures(n: int, h: int = 240, w: int = 320, seed: int = 0, shift: int = 24) -> np.ndarray:
    """n views of one seeded random texture, each `shift` px to the right
    of the last, so the pairs have true matches."""
    rng = np.random.default_rng(seed)
    big_w = w + shift * (n - 1)
    img = cv2.resize(rng.random((h // 8, big_w // 8)).astype(np.float32), (big_w, h),
                     interpolation=cv2.INTER_CUBIC)
    img += 0.3 * cv2.GaussianBlur(rng.random((h, big_w)).astype(np.float32), (0, 0), 1.5)
    img = np.round((img - img.min()) / (img.max() - img.min()) * 255.0) / 255.0
    return np.stack([img[:, i * shift:i * shift + w] for i in range(n)]).astype(np.float32)


@pytest.fixture(scope="module")
def both():
    imgs = torch.from_numpy(textures(3))
    return imgs, TO.orb_features(imgs, max_features=CAPACITY), R.orb(imgs, CAPACITY)


@pytest.mark.parametrize("path", ["tests/plain_orb.py", "h100bench/plain_orb.py"])
def test_the_reference_imports_none_of_the_packages(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "contextlib", "math", "numpy", "torch"}, names


def test_the_benchmark_s_copy_is_frozen_from_this_one():
    with open(os.path.join(ROOT, "tests", "plain_orb.py"), "rb") as a, \
            open(os.path.join(ROOT, "h100bench", "plain_orb.py"), "rb") as b:
        assert a.read() == b.read()


def test_constants_rebuilt_from_their_definitions_equal_the_port_s():
    np.testing.assert_array_equal(R.brief_pattern(), TO._PATTERN)
    np.testing.assert_array_equal(np.array(R.RING, np.int32), TO._FAST_RING)
    for n_in, n_out in ((240, 200), (320, 267), (97, 81), (50, 42)):
        np.testing.assert_array_equal(R.resize_weights(n_in, n_out).numpy(),
                                      TO._resize_weights(n_in, n_out, "cpu").numpy())


def test_packing_and_expansion_equal_the_port_s():
    bits = torch.from_numpy(np.random.default_rng(3).integers(0, 2, (4, 9, 256)).astype(np.uint8))
    packed = R.pack(bits)
    assert torch.equal(packed, TM.packbits_little(bits))
    assert torch.equal(R.expand(packed), TM.expand_binary_descriptors(packed))


def test_port_orb_agrees_with_the_plain_reference(both):
    _, port, ref = both
    assert int(port["valid"].sum()) == 3 * CAPACITY
    got = R.compare(port, ref)
    assert got["fails"] == []
    n = got["counts"]
    assert n["keypoints"] == int(ref["valid"].sum()) and n["unpaired"] == 0
    assert n["bits"] == 256 * n["keypoints"] and n["near_zero_bits"] < 0.001 * n["bits"]


def test_hamming_2nn_and_ratio_survivors_agree_exactly(both):
    from sfm_mvs_pipeline_tpu_torch.ops.kernels.match_kernel import two_nn_batch_fused

    _, port, _ = both
    desc = TM.expand_binary_descriptors(port["descriptors"])
    valid = port["valid"]
    pairs = torch.as_tensor(make_pairs("unordered", 3), dtype=torch.int32)
    best, mask = TM.match_pairs_batch(desc.to(torch.bfloat16), valid, pairs)
    _, best_sq, second_sq = two_nn_batch_fused(desc.to(torch.bfloat16), valid, pairs)
    ref = R.two_nn(desc, valid, pairs.numpy())
    vq = valid[pairs[:, 0].long()]
    got = R.compare_matches(best, mask, ref, vq)
    assert got["fails"] == [], got
    assert got["counts"]["survivors"] > 100
    np.testing.assert_array_equal(best_sq[vq].numpy(), ref["best_sq"][vq].numpy())
    np.testing.assert_array_equal(second_sq[vq].numpy(), ref["second_sq"][vq].numpy())
    p, q = torch.nonzero(vq, as_tuple=True)
    q_desc = desc[pairs[p, 0].long(), q]
    t_desc = desc[pairs[p, 1].long(), ref["best"][p, q]]
    hamming = (q_desc != t_desc).sum(-1).to(torch.float32)
    assert torch.equal(ref["best_sq"][p, q], 4.0 * hamming)


def test_the_reference_in_bfloat16_fails_the_comparison(both):
    imgs, port, _ = both
    low = R.orb(imgs, CAPACITY, dtype=torch.bfloat16)
    assert R.compare(port, low)["fails"]
