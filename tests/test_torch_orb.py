"""The port's ORB frontend (ops/orb.py) and binary-descriptor helpers
against the JAX package's, on the bundled insel images, plus the mirrors
of tests/test_orb.py on the port.

Images are the first two insel views at their stored size (360x202), as in
tests/test_orb.py, at max_features=512. Tolerances, stated per test:
  * the BRIEF pattern (this slice's "weights") and the bit packing: exact;
  * level-0 FAST corner masks: exact (comparisons of identical floats);
    Harris response: 1e-5 absolute (the same separable blur, float32 sums
    in another order);
  * pyramid level 1: 1e-6 absolute of jax.image.resize (weights built the
    way jax.image.scale_and_translate builds them, two products);
  * whole pipeline at subpixel=False (the JAX package's keypoints): >= 99%
    of JAX's keypoints found within 0.5 px, >= 99% of the descriptor bits
    of shared keypoints equal. Top-k near-ties and bilinear samples within
    float rounding of a BRIEF comparison's threshold flip a few;
  * subpixel=True: every output but the keypoints bit-equal to
    subpixel=False, each keypoint inside its whole level pixel; on a render
    at the 1080p render's texel scale, matched keypoints transferred
    through the true geometry land >= 20% closer (median) than the JAX
    package's, and within 0.9 px.
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_mvs_pipeline_tpu.ops import matching as JM
from sfm_mvs_pipeline_tpu.ops import orb as JO
from sfm_mvs_pipeline_tpu_torch.ops import matching as TM
from sfm_mvs_pipeline_tpu_torch.ops import orb as TO

torch.set_num_threads(2)

INSEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_data", "insel")


def _insel(n=2):
    return np.stack([cv2.imread(os.path.join(INSEL, f"{i}.jpg"), cv2.IMREAD_GRAYSCALE)
                     for i in range(1, n + 1)])


@pytest.fixture(scope="module")
def orb_both():
    imgs = _insel(2)
    out_j = {k: np.asarray(v) for k, v in JO.orb_features(jnp.asarray(imgs), max_features=512).items()}
    out_t = {k: v.numpy() for k, v in TO.orb_features(torch.from_numpy(imgs), max_features=512,
                                                      subpixel=False).items()}
    return imgs, out_j, out_t


def test_brief_pattern_is_jax_bit_for_bit():
    assert TO._PATTERN.dtype == JO._PATTERN.dtype == np.float32
    np.testing.assert_array_equal(TO._PATTERN, JO._PATTERN)
    np.testing.assert_array_equal(TO._brief_pattern(7), JO._brief_pattern(7))
    np.testing.assert_array_equal(TO._FAST_RING, JO._FAST_RING)


def test_expand_and_packbits_round_trip(rng):
    """expand_binary_descriptors equals JAX's little-endian unpackbits
    expansion exactly; packbits_little inverts it and equals numpy's
    packbits(bitorder="little")."""
    packed = rng.integers(0, 256, size=(2, 17, 32)).astype(np.uint8)
    e_t = TM.expand_binary_descriptors(torch.from_numpy(packed))
    e_j = np.asarray(JM.expand_binary_descriptors(jnp.asarray(packed)))
    assert e_t.dtype == torch.float32 and e_t.shape == (2, 17, 256)
    np.testing.assert_array_equal(e_t.numpy(), e_j)
    bits = (e_t > 0).to(torch.uint8)
    np.testing.assert_array_equal(TM.packbits_little(bits).numpy(), packed)
    np.testing.assert_array_equal(
        TM.packbits_little(bits).numpy(), np.packbits(bits.numpy(), axis=-1, bitorder="little"))


def test_shift2d_wraps_like_jnp_roll(rng):
    """_shift2d is a circular shift (jnp.roll), not the edge clamp its JAX
    docstring names."""
    img = rng.random((2, 9, 11)).astype(np.float32)
    for dx, dy in ((3, -1), (-2, 2), (0, 3)):
        np.testing.assert_array_equal(TO._shift2d(torch.from_numpy(img), dx, dy).numpy(),
                                      np.asarray(JO._shift2d(jnp.asarray(img), dx, dy)))


def test_fast_mask_and_harris_level0():
    """Level 0: FAST corner masks equal; Harris within 1e-5 where both are
    corners; the 3x3 NMS keeps the same pixels."""
    f = _insel(2).astype(np.float32) / 255.0
    sj = np.asarray(JO.fast_score(jnp.asarray(f)))
    st = TO.fast_score(torch.from_numpy(f)).numpy()
    corner = np.isfinite(sj)
    assert corner.sum() > 1000
    np.testing.assert_array_equal(np.isfinite(st), corner)
    np.testing.assert_allclose(st[corner], sj[corner], atol=1e-5, rtol=0)
    nj = np.asarray(JO._nms3x3(jnp.asarray(sj)))
    nt = TO._nms3x3(torch.from_numpy(sj)).numpy()
    np.testing.assert_array_equal(nt, nj)


def test_pyramid_level1_matches_jax_resize():
    """One pyramid step, 360x202 -> 300x168 at scale 1.2, against
    jax.image.resize(method="linear") (antialiased): within 1e-6; and a
    second step from JAX's own level 1, so the weights hold at odd sizes."""
    x = _insel(2).astype(np.float32) / 255.0
    for _ in range(2):
        h, w = x.shape[1:]
        nh, nw = int(round(h / 1.2)), int(round(w / 1.2))
        rj = np.asarray(JO.jax.image.resize(jnp.asarray(x), (2, nh, nw), method="linear"))
        rt = TO.resize_linear(torch.from_numpy(x), nh, nw).numpy()
        assert rt.shape == rj.shape
        np.testing.assert_allclose(rt, rj, atol=1e-6, rtol=0)
        x = rj


def test_orb_features_match_jax(orb_both):
    _, out_j, out_t = orb_both
    for k in ("keypoints", "angle", "response", "scale", "valid", "descriptors"):
        assert out_t[k].shape == out_j[k].shape, k
    assert out_t["descriptors"].dtype == np.uint8
    for b in range(2):
        kj = out_j["keypoints"][b][out_j["valid"][b]]
        kt = out_t["keypoints"][b][out_t["valid"][b]]
        assert abs(len(kt) - len(kj)) <= 0.01 * len(kj)
        dist = np.linalg.norm(kj[:, None] - kt[None], axis=-1)
        nn = dist.argmin(1)
        found = dist.min(1) <= 0.5
        assert found.mean() >= 0.99, found.mean()
        bj = np.unpackbits(out_j["descriptors"][b][out_j["valid"][b]][found], axis=-1)
        bt = np.unpackbits(out_t["descriptors"][b][out_t["valid"][b]][nn[found]], axis=-1)
        assert (bj == bt).mean() >= 0.99, (bj == bt).mean()


def test_subpixel_refines_only_the_keypoints(orb_both):
    """subpixel=True changes nothing but the keypoints, and moves each
    within its whole pixel of its level: (k + 0.5) * W_level / W - 0.5 lies
    within 0.5 of the level pixel that k / 1.2^level names."""
    imgs, _, out_w = orb_both
    out_s = {k: v.numpy() for k, v in TO.orb_features(torch.from_numpy(imgs), max_features=512).items()}
    for k in ("angle", "response", "scale", "valid", "descriptors"):
        np.testing.assert_array_equal(out_s[k], out_w[k], err_msg=k)
    sizes = [imgs.shape[1:]]
    for _ in range(7):
        sizes.append(tuple(int(round(n / 1.2)) for n in sizes[-1]))
    v = out_w["valid"]
    lev = np.rint(np.log(out_w["scale"][v]) / np.log(1.2)).astype(int)
    whole = out_w["keypoints"][v] / out_w["scale"][v][:, None]
    np.testing.assert_allclose(whole, np.rint(whole), atol=1e-3)
    lvl_wh = np.array([(sizes[l][1], sizes[l][0]) for l in lev], np.float64)
    back = (out_s["keypoints"][v] + 0.5) * lvl_wh / np.array([imgs.shape[2], imgs.shape[1]]) - 0.5
    assert np.abs(back - np.rint(whole)).max() <= 0.5 + 1e-3
    assert np.abs(out_s["keypoints"][v] - out_w["keypoints"][v]).max() > 0.1


def _transfer_errors(out, gt_R, gt_C, views, h, w, f):
    """Median distance, over ratio-test matches of every pair of `views`,
    between a keypoint sent through the render's true geometry (the z = 7
    disc or the z = 10 plane of utils/synth.py) and its match."""
    def transfer(p, i, j):
        d = np.stack([(p[:, 0] - w / 2) / f, (p[:, 1] - h / 2) / f, np.ones(len(p))], -1) @ gt_R[i]
        x7 = gt_C[i] + ((7 - gt_C[i][2]) / d[:, 2])[:, None] * d
        disc = ((x7[:, 0] - 2) ** 2 + x7[:, 1] ** 2) < 4
        x = np.where(disc[:, None], x7, gt_C[i] + ((10 - gt_C[i][2]) / d[:, 2])[:, None] * d)
        pc = (x - gt_C[j]) @ gt_R[j].T
        return np.stack([f * pc[:, 0] / pc[:, 2] + w / 2, f * pc[:, 1] / pc[:, 2] + h / 2], -1)

    errs = []
    for a in range(len(views)):
        for b in range(a + 1, len(views)):
            bi, mask = _match_port(out, a, b)
            kq = out["keypoints"][a][mask].astype(np.float64)
            kt = out["keypoints"][b][bi[mask]].astype(np.float64)
            errs.append(np.linalg.norm(transfer(kq, views[a], views[b]) - kt, axis=1))
    return float(np.median(np.concatenate(errs)))


def test_subpixel_localisation_against_ground_truth(tmp_path):
    """At the 1080p render's texel scale (f = 1680 px, a texel ~3 px), most
    corners come from the coarse levels, where a whole level pixel is up to
    3.6 image pixels. Rendered here at 480x270 with f = 1680: the JAX
    package's keypoints and the port's at subpixel=False land equally far
    from the truth (within 0.05 px); subpixel=True lands >= 20% closer and
    within 0.9 px."""
    from sfm_mvs_pipeline_tpu_torch.utils.synth import render_views

    h, w, f, views = 270, 480, 1680.0, (0, 1, 2)
    paths, gt_R, gt_C = render_views(str(tmp_path), 12, h, w, f)
    imgs = np.stack([cv2.imread(paths[v], cv2.IMREAD_GRAYSCALE) for v in views])
    out_j = {k: np.asarray(v) for k, v in JO.orb_features(jnp.asarray(imgs), max_features=1024).items()}
    err = {}
    for name, sub in (("whole", False), ("subpixel", True)):
        out = {k: v.numpy() for k, v in TO.orb_features(torch.from_numpy(imgs), max_features=1024,
                                                          subpixel=sub).items()}
        err[name] = _transfer_errors(out, gt_R, gt_C, views, h, w, f)
    err["jax"] = _transfer_errors(out_j, gt_R, gt_C, views, h, w, f)
    assert abs(err["jax"] - err["whole"]) < 0.05, err
    assert err["subpixel"] <= 0.8 * err["whole"], err
    assert err["subpixel"] < 0.9, err


def _match_port(out, a, b):
    e = TM.expand_binary_descriptors(torch.from_numpy(out["descriptors"]))
    v = torch.from_numpy(out["valid"])
    bi, bsq, ssq = TM.two_nn(e[a], e[b], v[a], v[b])
    mask = TM.ratio_test_mask(bsq, ssq, v[a], ratio=0.8).numpy()
    return bi.numpy(), mask


def test_orb_detects_and_matches_insel(orb_both):
    """Mirror of tests/test_orb.py::test_orb_detects_and_matches_insel on
    the port: > 300 features per image, > 60 Hamming ratio-test matches,
    homography inlier share > 0.6."""
    _, _, out = orb_both
    assert out["valid"].sum(axis=1).min() > 300
    assert out["descriptors"].shape == (2, 512, 32)
    bi, mask = _match_port(out, 0, 1)
    assert mask.sum() > 60, int(mask.sum())
    kq = out["keypoints"][0][mask]
    kt = out["keypoints"][1][bi[mask]]
    _, inl = cv2.findHomography(kq, kt, cv2.RANSAC, 5.0)
    assert inl is not None and inl.sum() / len(kq) > 0.6


def test_orb_rotation_invariance():
    """Mirror of tests/test_orb.py::test_orb_rotation_invariance on the
    port: a 30-degree in-plane rotation keeps > 40 matches with a median
    error < 3 px under the known rotation."""
    img = _insel(1)[0]
    h, w = img.shape
    M = cv2.getRotationMatrix2D((w / 2, h / 2), 30, 1.0)
    rot = cv2.warpAffine(img, M, (w, h))
    out = {k: v.numpy() for k, v in TO.orb_features(torch.from_numpy(np.stack([img, rot])),
                                                      max_features=512).items()}
    bi, mask = _match_port(out, 0, 1)
    assert mask.sum() > 40, int(mask.sum())
    kq = out["keypoints"][0][mask]
    kt = out["keypoints"][1][bi[mask]]
    pred = np.hstack([kq, np.ones((len(kq), 1))]) @ M.T
    assert np.median(np.linalg.norm(pred - kt, axis=1)) < 3.0
