"""A plain PyTorch reference of the port's ORB front end and of its Hamming
2-NN matching, written from the stated semantics, not from the port.

It imports neither jax, the JAX package nor the port: every constant is
rebuilt from its definition (the FAST ring, the Gaussian taps, the
pyramid's resize weights, the BRIEF pattern), and every step runs image by
image in one precision, float32 by default (TF32 off). The same file is
frozen as h100bench/plain_orb.py for the comparison on the card.

Semantics (ORB as the port states it, after cv::ORB with HARRIS_SCORE):
  * images as float in [0, 1] (uint8 over 255);
  * an image pyramid at scale 1.2, at most 8 levels, stopping at a level
    whose shorter side is under 2 * 17 + 8 pixels; level l + 1 is level l
    resized to round(h / 1.2) x round(w / 1.2) by the antialiased linear
    resize (a triangle kernel widened by the scale, columns normalised,
    samples outside the input zeroed; jax.image.resize "linear");
  * on each level, the FAST-9 segment test on the 16-pixel Bresenham ring
    of radius 3 at threshold 0.08: 9 contiguous ring pixels (circularly)
    all brighter than centre + t or all darker than centre - t; the image
    read with wrap-around (a circular shift; the wrapped rows fall in the
    border);
  * the Harris response (k = 0.04) of central differences, the three
    products blurred by a separable Gaussian of sigma 1.5 (taps of radius
    ceil(3 sigma), normalised in float64, edges replicated, summed first
    tap first, rows then columns), at FAST corners, -inf elsewhere; a 3x3
    non-maximum suppression (a score survives where it equals its window's
    maximum); a border of 17 pixels masked;
  * the top min(max(N // (l + 1), 64), h w) scores of level l, N the
    capacity, in descending order, the lower flat index first among equals;
  * keypoints refined to the Harris peak (the vertex of the parabola
    through the pixel and its two neighbours on each axis, clamped to half
    a pixel, 0 where it does not bend down) and mapped to the image by
    (x + 0.5) W / w_l - 0.5;
  * the intensity-centroid angle atan2(m01, m10) over the bilinear samples
    (zero outside the level) of a radius-15 disc of the level;
  * steered BRIEF on the level blurred at sigma 2: 256 tests of the pattern
    drawn as numpy's default_rng(1234).normal(0, 31 / 5, (256, 4)),
    clipped to +-14, rotated by the angle; bit i is I(p1) < I(p2);
  * the levels' candidates in level order, the top N by response among the
    valid; bits packed little-endian (bit i of byte j is element 8 j + i)
    and expanded to +-1 float32 (2 bit - 1);
  * the 2-NN by |a - b|^2 = 4 hamming(a, b) over the +-1 expansion,
    invalid targets at 3e38, the lowest target index on ties; the ratio
    test best < 0.7^2 second on squared distances, for valid queries.

Departures from the port, each a choice of how, not of what:
  * one image at a time, no chunking of the keypoints;
  * top-k by a full stable sort (the port takes the k-th value first);
  * non-maximum suppression by eight shifted comparisons, not max_pool2d;
  * the 2-NN over each pair's valid slots alone (the port sweeps the
    capacity and masks), indices mapped back to slots;
  * every float step in `dtype`, so the same code in bfloat16 is the
    control that the comparison (`compare`) has to catch.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

N_BITS = 256
PATCH = 31
BORDER = PATCH // 2 + 2
R_ORIENT = 15
BIG = 3.0e38
RING = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))

# Tolerances of `compare`, each with its reason. The reference runs the
# same float32 formulas in the same order as the port states them, so on
# one device most numbers agree bit for bit; what differs is rounding of
# reductions whose order the two implementations lay out differently.
KP_TOL_PX = 1e-3  # keypoint position: float32 rounding of x + offset at 1920 px is ~1e-4
ANGLE_TOL = 1e-3  # radians: atan2 of sums of 961 samples, each rounded at ~6e-8
# Harris: det - 0.04 tr^2 of products blurred over 19 taps, a difference
# that cancels, so float32 rounding of the sums (~1e-7 of tr^2) reaches
# ~1e-4 of the response; 1.5e-4 on the card at 1080p (batched blur there)
RESPONSE_RTOL = 1e-3
# a BRIEF bit may differ only where its two samples lie within float
# rounding of each other (a bilinear sum of four products at ~6e-8 each)
MARGIN_TOL = 1e-5
# keypoints selected by one side and not the other: only those whose
# response ties the cut-off of a top-k within that rounding
CUTOFF_SLACK = RESPONSE_RTOL


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for matmuls and convolutions inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) float32 test pairs (x1, y1, x2, y2) around the keypoint."""
    lim = PATCH // 2 - 1
    pts = np.random.default_rng(seed).normal(0.0, PATCH / 5.0, size=(N_BITS, 4))
    return np.clip(pts, -lim, lim).astype(np.float32)


def gauss_taps(sigma: float) -> np.ndarray:
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of one (H, W) plane, edges replicated, rows
    (along y) then columns, taps summed first to last."""
    k = gauss_taps(sigma)
    r = len(k) // 2
    h, w = img.shape
    p = torch.cat([img[:1].expand(r, w), img, img[-1:].expand(r, w)], 0)
    out = None
    for i, ki in enumerate(k):
        term = p[i:i + h] * float(ki)
        out = term if out is None else out + term
    p = torch.cat([out[:, :1].expand(h, r), out, out[:, -1:].expand(h, r)], 1)
    out = None
    for i, ki in enumerate(k):
        term = p[:, i:i + w] * float(ki)
        out = term if out is None else out + term
    return out


def at(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[y, x] = img[(y + dy) mod H, (x + dx) mod W]."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def fast9(img: torch.Tensor, t: float) -> torch.Tensor:
    """The FAST-9 segment test of every pixel of one plane."""
    ring = torch.stack([at(img, dx, dy) for dx, dy in RING])
    out = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    for side in (ring > img + t, ring < img - t):
        for s in range(16):
            out |= side[[(s + j) % 16 for j in range(9)]].all(0)
    return out


def harris(img: torch.Tensor) -> torch.Tensor:
    dx = (at(img, 1, 0) - at(img, -1, 0)) * 0.5
    dy = (at(img, 0, 1) - at(img, 0, -1)) * 0.5
    a, b, c = blur(dx * dx, 1.5), blur(dy * dy, 1.5), blur(dx * dy, 1.5)
    return (a * b - c * c) - 0.04 * (a + b) * (a + b)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """Scores that equal the maximum of their 3x3 window (-inf beyond the
    plane), -inf elsewhere."""
    h, w = score.shape
    pad = torch.full((h + 2, w + 2), float("-inf"), dtype=score.dtype, device=score.device)
    pad[1:-1, 1:-1] = score
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            keep &= score >= pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return torch.where(keep, score, torch.full_like(score, float("-inf")))


def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) antialiased linear resize weights along one axis, in
    float64, rounded once to float32."""
    inv = n_in / n_out
    widen = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    wgt = np.maximum(0.0, 1.0 - np.abs(centre[None, :] - np.arange(n_in)[:, None]) / widen)
    total = wgt.sum(0, keepdims=True)
    wgt = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                   wgt / np.where(total != 0, total, 1.0), 0.0)
    wgt[:, (centre < -0.5) | (centre > n_in - 0.5)] = 0.0
    return torch.from_numpy(wgt.astype(np.float32))


def resize(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    wy = resize_weights(img.shape[0], nh).to(img.device, img.dtype)
    wx = resize_weights(img.shape[1], nw).to(img.device, img.dtype)
    return torch.einsum("bhw,hH,wW->bHW", img[None], wy, wx)[0]


def sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of one plane, zero outside it."""
    h, w = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xi, yi = x0.long(), y0.long()

    def px(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(inside, v, torch.zeros_like(v))

    return (px(yi, xi) * (1 - fx) * (1 - fy) + px(yi, xi + 1) * fx * (1 - fy)
            + px(yi + 1, xi) * (1 - fx) * fy + px(yi + 1, xi + 1) * fx * fy)


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of a flat vector, descending, the lower index first
    among equals; past its length, -inf at index 0."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    if k > len(scores):
        vals = torch.cat([vals, vals.new_full((k - len(scores),), float("-inf"))])
        idx = torch.cat([idx, idx.new_zeros(k - len(scores))])
    return vals, idx


def peak_offset(hr: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    h, w = hr.shape
    xi, yi = xs.long().clamp(1, w - 2), ys.long().clamp(1, h - 2)
    c = hr[yi, xi]

    def vertex(m, p):
        den = m + p - 2 * c
        bends = den < 0
        off = 0.5 * (m - p) / torch.where(bends, den, torch.ones_like(den))
        return torch.where(bends, off.clamp(-0.5, 0.5), torch.zeros_like(off))

    return vertex(hr[yi, xi - 1], hr[yi, xi + 1]), vertex(hr[yi - 1, xi], hr[yi + 1, xi])


def orientation(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    g = torch.arange(-R_ORIENT, R_ORIENT + 1, dtype=img.dtype, device=img.device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    disc = ((gx * gx + gy * gy) <= R_ORIENT * R_ORIENT).to(img.dtype)
    v = sample(img, xs[:, None, None] + gx, ys[:, None, None] + gy) * disc
    return torch.atan2(torch.sum(v * gy, dim=(1, 2)), torch.sum(v * gx, dim=(1, 2)))


def brief(img: torch.Tensor, xs, ys, ang) -> tuple[torch.Tensor, torch.Tensor]:
    """(bits (K, 256) uint8, margins I(p2) - I(p1) (K, 256))."""
    pat = torch.as_tensor(brief_pattern(), device=img.device).to(img.dtype)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x, y = xs[:, None], ys[:, None]
    i1 = sample(img, c * pat[:, 0] - s * pat[:, 1] + x, s * pat[:, 0] + c * pat[:, 1] + y)
    i2 = sample(img, c * pat[:, 2] - s * pat[:, 3] + x, s * pat[:, 2] + c * pat[:, 3] + y)
    return (i1 < i2).to(torch.uint8), i2 - i1


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8B) 0/1 -> (..., B) uint8, little-endian within a byte."""
    b = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.int32)
    return (b << torch.arange(8, device=bits.device, dtype=torch.int32)).sum(-1).to(torch.uint8)


def expand(packed: torch.Tensor) -> torch.Tensor:
    """(..., B) uint8 -> (..., 8B) +-1 float32."""
    bits = (packed[..., None].to(torch.int32) >> torch.arange(8, device=packed.device)) & 1
    return bits.reshape(*packed.shape[:-1], -1).to(torch.float32) * 2.0 - 1.0


def orb_one(image: torch.Tensor, capacity: int, dtype=torch.float32, n_levels: int = 8,
            scale: float = 1.2, threshold: float = 0.08) -> dict:
    """ORB of one (H, W) image: keypoints (N, 2), angle, response, scale,
    valid (N,), descriptors (N, 32) uint8 and margins (N, 256), N the
    capacity."""
    img = image.to(torch.float32) / 255.0 if image.dtype == torch.uint8 else image
    img = img.to(dtype)
    h, w = img.shape
    levels = []
    for lev in range(n_levels):
        hl, wl = img.shape
        if min(hl, wl) < 2 * BORDER + 8:
            break
        hr = harris(img)
        score = nms3(torch.where(fast9(img, threshold), hr, torch.full_like(hr, float("-inf"))))
        inner = torch.zeros_like(score, dtype=torch.bool)
        inner[BORDER:hl - BORDER, BORDER:wl - BORDER] = True
        score = torch.where(inner, score, torch.full_like(score, float("-inf")))
        vals, idx = top_k(score.reshape(-1), min(max(capacity // (lev + 1), 64), hl * wl))
        ys, xs = (idx // wl).to(dtype), (idx % wl).to(dtype)
        ang = orientation(img, xs, ys)
        bits, margins = brief(blur(img, 2.0), xs, ys, ang)
        ox, oy = peak_offset(hr, xs, ys)
        valid = torch.isfinite(vals)
        levels.append({
            "keypoints": torch.stack([(xs + ox + 0.5) * (w / wl) - 0.5,
                                      (ys + oy + 0.5) * (h / hl) - 0.5], -1),
            "angle": ang, "response": vals, "scale": torch.full_like(ang, scale ** lev),
            "valid": valid, "bits": bits, "margins": margins})
        img = resize(img, int(round(hl / scale)), int(round(wl / scale)))
    cat = {k: torch.cat([lv[k] for lv in levels]) for k in levels[0]}
    score = torch.where(cat["valid"], cat["response"],
                        torch.full_like(cat["response"], float("-inf")))
    chosen, top = top_k(score, capacity)
    out = {k: cat[k][top] for k in ("keypoints", "angle", "response", "scale", "margins")}
    out["valid"] = cat["valid"][top] & torch.isfinite(chosen)
    out["descriptors"] = pack(cat["bits"][top])
    return out


def orb(images: torch.Tensor, capacity: int, dtype=torch.float32) -> dict:
    """ORB of a (B, H, W) batch, one image at a time, stacked."""
    with _full_fp32():
        one = [orb_one(im, capacity, dtype) for im in images]
    return {k: torch.stack([o[k] for o in one]) for k in one[0]}


def two_nn(desc: torch.Tensor, valid: torch.Tensor, pairs, ratio: float = 0.7,
           dtype=torch.float32) -> dict:
    """Hamming 2-NN of every (query shot, target shot) row of `pairs` over
    +-1 descriptors (S, N, 256): best (P, N) target slot, best and second
    squared distances (4 x Hamming; 3e38 where the query or every target is
    invalid), and the ratio test's survivors, all at the valid queries."""
    P, N = len(pairs), desc.shape[1]
    dev = desc.device
    best = torch.zeros((P, N), dtype=torch.int64, device=dev)
    d1 = torch.full((P, N), BIG, dtype=torch.float32, device=dev)
    d2 = torch.full((P, N), BIG, dtype=torch.float32, device=dev)
    with _full_fp32():
        for p, (a, b) in enumerate(np.asarray(pairs).reshape(-1, 2).tolist()):
            qi = torch.nonzero(valid[a])[:, 0]
            ti = torch.nonzero(valid[b])[:, 0]
            if len(qi) == 0 or len(ti) == 0:
                continue
            q, t = desc[a, qi].to(dtype), desc[b, ti].to(dtype)
            sq = ((q * q).sum(-1)[:, None] + (t * t).sum(-1)[None, :] - 2.0 * (q @ t.T)).float()
            j = torch.argmin(sq, dim=1)
            first = sq.gather(1, j[:, None])[:, 0]
            second = sq.scatter(1, j[:, None], float("inf")).amin(1) if len(ti) > 1 else \
                torch.full_like(first, BIG)
            best[p, qi], d1[p, qi], d2[p, qi] = ti[j], first, second
    vq = valid[torch.as_tensor(np.asarray(pairs).reshape(-1, 2)[:, 0], device=dev)]
    mask = (d1 < (ratio * ratio) * d2) & vq & (d1 < BIG)
    return {"best": best, "best_sq": d1, "second_sq": d2, "mask": mask}


def _pairs(P: dict, R: dict, v: int) -> tuple[np.ndarray, np.ndarray, list, list]:
    """(port slots, reference slots) of the keypoints of view v that both
    sides selected, and the slots only the port's / the reference's hold:
    by slot where the two agree within KP_TOL_PX at one scale, then the
    rest by the nearest such keypoint."""
    pv, rv = P["valid"][v], R["valid"][v]
    n = min(len(pv), len(rv))
    same = (pv[:n] & rv[:n] & (P["scale"][v, :n] == R["scale"][v, :n])
            & (np.abs(P["keypoints"][v, :n] - R["keypoints"][v, :n]).max(-1) <= KP_TOL_PX))
    i, j = list(np.nonzero(same)[0]), list(np.nonzero(same)[0])
    left_p = [a for a in np.nonzero(pv)[0] if not (a < n and same[a])]
    left_r = [b for b in np.nonzero(rv)[0] if not (b < n and same[b])]
    only_r = []
    for b in left_r:
        near = [a for a in left_p if P["scale"][v, a] == R["scale"][v, b]
                and np.abs(P["keypoints"][v, a] - R["keypoints"][v, b]).max() <= KP_TOL_PX]
        if near:
            i.append(near[0])
            j.append(b)
            left_p.remove(near[0])
        else:
            only_r.append(b)
    return np.array(i, np.int64), np.array(j, np.int64), left_p, only_r


def compare(port: dict, ref: dict) -> dict:
    """The port's ORB outputs against the reference's, for one batch.

    Keypoints are paired by slot, or else by position at the same scale
    (`_pairs`); a keypoint that only one side selects must tie the
    selection's cut-off (its response within CUTOFF_SLACK of the least
    response selected). Paired keypoints must agree in position
    (KP_TOL_PX, by the pairing), angle (ANGLE_TOL), response
    (RESPONSE_RTOL) and every bit whose reference margin is at least
    MARGIN_TOL. Returns counts and a list of failures (empty when the two
    agree)."""
    fails, n = [], {"views": 0, "keypoints": 0, "unpaired": 0, "bits": 0, "near_zero_bits": 0,
                    "bits_differing": 0, "max_kp_px": 0.0, "max_angle": 0.0,
                    "max_response_rel": 0.0}
    P = {k: np.asarray(v.float().cpu() if torch.is_tensor(v) and v.dtype == torch.bfloat16
                       else v.cpu() if torch.is_tensor(v) else v) for k, v in port.items()}
    R = {k: np.asarray(v.float().cpu() if torch.is_tensor(v) and v.dtype == torch.bfloat16
                       else v.cpu() if torch.is_tensor(v) else v) for k, v in ref.items()}
    for v in range(len(R["valid"])):
        n["views"] += 1
        i, j, only_p, only_r = _pairs(P, R, v)
        cut = min([float(D["response"][v][D["valid"][v]].min()) for D in (P, R)
                   if D["valid"][v].any()] or [0.0])
        for side, D, slots in (("port", P, only_p), ("reference", R, only_r)):
            for a in slots:
                n["unpaired"] += 1
                r = float(D["response"][v, a])
                if abs(r - cut) > CUTOFF_SLACK * max(abs(cut), 1e-30):
                    fails.append(f"view {v}: keypoint {D['keypoints'][v, a].tolist()} only in "
                                 f"the {side}'s selection (response {r:.6g}, cut-off {cut:.6g})")
        if not len(i):
            continue
        n["keypoints"] += len(i)
        dkp = float(np.abs(P["keypoints"][v, i] - R["keypoints"][v, j]).max())
        dang = np.abs(np.angle(np.exp(1j * (P["angle"][v, i].astype(np.float64)
                                            - R["angle"][v, j].astype(np.float64)))))
        rr = np.abs(P["response"][v, i] - R["response"][v, j]) / np.maximum(
            np.abs(R["response"][v, j]), 1e-30)
        n["max_kp_px"] = max(n["max_kp_px"], dkp)
        n["max_angle"] = max(n["max_angle"], float(dang.max()))
        n["max_response_rel"] = max(n["max_response_rel"], float(rr.max()))
        if dang.max() > ANGLE_TOL:
            fails.append(f"view {v}: angles {dang.max():.3g} rad apart")
        if rr.max() > RESPONSE_RTOL:
            fails.append(f"view {v}: responses {rr.max():.3g} apart (relative)")
        pb = np.unpackbits(P["descriptors"][v, i], axis=-1, bitorder="little")
        rb = np.unpackbits(R["descriptors"][v, j], axis=-1, bitorder="little")
        near = np.abs(R["margins"][v, j]) < MARGIN_TOL
        differ = pb != rb
        n["bits"] += differ.size
        n["near_zero_bits"] += int(near.sum())
        n["bits_differing"] += int(differ.sum())
        bad = int((differ & ~near).sum())
        if bad:
            fails.append(f"view {v}: {bad} descriptor bits differ away from a near-zero test")
    return {"counts": n, "fails": fails}


def compare_matches(port_best, port_mask, ref: dict, valid) -> dict:
    """The port's 2-NN (best target slot, ratio survivors) against the
    reference's, at every valid query: both exactly."""
    pb, pm = np.asarray(port_best).astype(np.int64), np.asarray(port_mask, bool)
    rb, rm = ref["best"].cpu().numpy(), ref["mask"].cpu().numpy()
    vq = np.asarray(valid, bool)
    diff_best = int(((pb != rb) & vq).sum())
    diff_mask = int((pm != rm).sum())
    fails = ([f"{diff_best} best targets differ"] if diff_best else []) + (
        [f"{diff_mask} ratio survivors differ"] if diff_mask else [])
    return {"counts": {"queries": int(vq.sum()), "survivors": int(rm.sum()),
                       "best_differ": diff_best, "survivors_differ": diff_mask}, "fails": fails}
