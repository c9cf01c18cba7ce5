"""Batched ORB feature detection + binary description on tensors.

Port of sfm_mvs_pipeline_tpu/ops/orb.py, the stand-in for the reference's
cv::ORB::create(featureLimit) frontend (ref:
src/cli/PhotogrammetrieCli.cpp:352-357), with the same structure: FAST-9
corners on an image pyramid (scale 1.2, 8 levels), Harris-response
ranking, intensity-centroid orientation, and a 256-bit rotated-BRIEF
descriptor from a deterministic seeded Gaussian pattern (the JAX package's
own, bit for bit: it only has to agree with itself across images).

Descriptors are returned as packed uint8 (B, F, 32), bits little-endian;
ops/matching.py::expand_binary_descriptors expands them to +-1 floats for
the matcher. Arithmetic follows the JAX package op for op, so the two agree
to float rounding; the pyramid's antialiased linear resize is rebuilt from
jax.image.scale_and_translate's weight matrices (`_resize_weights`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from sfm_mvs_pipeline_tpu_torch.ops.matching import packbits_little
from sfm_mvs_pipeline_tpu_torch.ops.sift import _bilinear, gaussian_blur
from sfm_mvs_pipeline_tpu_torch.ops.topk import select_top_k
from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import stage

# FAST circle of radius 3 (the standard 16-pixel Bresenham ring), (dx, dy)
_FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

N_BITS = 256
_PATCH = 31
_R_PAT = 15  # intensity-centroid radius
# keypoints per orientation/descriptor batch: bounds the (K, 31, 31) samples
_KP_CHUNK = 8192


def _brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) sampling pattern (x1, y1, x2, y2), Gaussian sigma = patch/5,
    drawn as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    sigma = _PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 4))
    lim = _PATCH // 2 - 1
    return np.clip(pts, -lim, lim).astype(np.float32)


_PATTERN = _brief_pattern()


def _shift2d(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[y, x] = img[(y + dy) mod H, (x + dx) mod W]: a circular shift,
    the JAX package's jnp.roll (its docstring's "edge clamp" is not what it
    does; the wrapped rows and columns fall inside the masked border)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _fast_corners(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 arc test: >= 9 contiguous ring pixels all brighter than c + t
    or all darker than c - t, for (B, H, W) images in [0, 1]."""
    ring = torch.stack([_shift2d(img, int(dx), int(dy)) for dx, dy in _FAST_RING])
    bright = ring > (img + threshold)[None]
    dark = ring < (img - threshold)[None]

    def arc9(mask):
        # any window of 9 contiguous (circular) positions all true
        acc = torch.zeros_like(mask[0])
        for start in range(16):
            acc = acc | torch.all(mask[np.arange(start, start + 9) % 16], dim=0)
        return acc

    return arc9(bright) | arc9(dark)


def _harris(img: torch.Tensor) -> torch.Tensor:
    """Harris response (k = 0.04) of central differences, the products
    blurred at sigma 1.5."""
    dx = (_shift2d(img, 1, 0) - _shift2d(img, -1, 0)) * 0.5
    dy = (_shift2d(img, 0, 1) - _shift2d(img, 0, -1)) * 0.5
    a = gaussian_blur(dx * dx, 1.5)
    b = gaussian_blur(dy * dy, 1.5)
    c = gaussian_blur(dx * dy, 1.5)
    det = a * b - c * c
    tr = a + b
    return det - 0.04 * tr * tr


def fast_score(img: torch.Tensor, threshold: float = 0.08) -> torch.Tensor:
    """FAST-9 corner mask + Harris score for (B, H, W) images in [0, 1]:
    -inf where the arc test fails, else the Harris response (cv ORB's
    HARRIS_SCORE ranking)."""
    return _score(_fast_corners(img, threshold), _harris(img))


def _score(corners: torch.Tensor, harris: torch.Tensor) -> torch.Tensor:
    """The Harris response at FAST corners, -inf elsewhere."""
    return torch.where(corners, harris, torch.full_like(harris, float("-inf")))


def _peak_offsets(harris: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Sub-pixel offsets (ox, oy) in [-0.5, 0.5] of the Harris peak at the
    whole pixels (xs, ys) of one (B, H, W) level: the vertex of the parabola
    through the pixel and its two neighbours along each axis, 0 where the
    three do not bend down."""
    b, h, w = harris.shape
    xi = xs.long().clamp(1, w - 2)
    yi = ys.long().clamp(1, h - 2)
    bi = torch.arange(b, device=harris.device)[:, None].expand_as(xi)
    c = harris[bi, yi, xi]

    def vertex(m, p):
        den = m + p - 2 * c
        bends = den < 0
        off = 0.5 * (m - p) / torch.where(bends, den, torch.ones_like(den))
        return torch.where(bends, off.clamp(-0.5, 0.5), torch.zeros_like(off))

    return (vertex(harris[bi, yi, xi - 1], harris[bi, yi, xi + 1]),
            vertex(harris[bi, yi - 1, xi], harris[bi, yi + 1, xi]))


def _nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep scores that equal the max of their 3x3 window (-inf padding)."""
    mx = TF.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where(score >= mx, score, torch.full_like(score, float("-inf")))


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of jax.image.resize(method="linear")
    along one axis (scale_and_translate's compute_weight_mat, translation
    0): a triangle kernel widened by 1/scale when downsampling, columns
    normalised, samples outside the input zeroed. Computed in float64 and
    rounded once, as JAX computes them with x64 enabled; JAX's float32 path
    (x64 off) rounds each step and lands ~5e-6 away."""
    f64 = torch.float64
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=f64) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=f64)[:, None]) / kernel_scale
    w = torch.clamp(1 - x, min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(torch.float32).to(device)


def resize_linear(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(B, H, W) -> (B, nh, nw), jax.image.resize(..., method="linear"),
    antialiased when downsampling: two separable weight products."""
    wy = _resize_weights(img.shape[-2], nh, img.device)
    wx = _resize_weights(img.shape[-1], nw, img.device)
    return torch.einsum("bhw,hH,wW->bHW", img, wy, wx)


def _orientation(im: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle over a circular patch of radius 15 around
    each keypoint of one (H, W) level."""
    lin = torch.arange(-_R_PAT, _R_PAT + 1, dtype=torch.float32, device=im.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    circ = ((gx * gx + gy * gy) <= _R_PAT * _R_PAT).to(torch.float32)
    out = []
    for c in range(0, len(xs), _KP_CHUNK):
        x0, y0 = xs[c : c + _KP_CHUNK], ys[c : c + _KP_CHUNK]
        v = _bilinear(im, x0[:, None, None] + gx[None], y0[:, None, None] + gy[None]) * circ[None]
        m10 = torch.sum(v * gx[None], dim=(1, 2))
        m01 = torch.sum(v * gy[None], dim=(1, 2))
        out.append(torch.atan2(m01, m10))
    return torch.cat(out)


def _brief(im: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF bits (K, 256) uint8 on one blurred (H, W) level."""
    pat = torch.as_tensor(_PATTERN, device=im.device)
    out = []
    for c in range(0, len(xs), _KP_CHUNK):
        x0, y0, a0 = xs[c : c + _KP_CHUNK, None], ys[c : c + _KP_CHUNK, None], ang[c : c + _KP_CHUNK]
        ca = torch.cos(a0)[:, None]
        sa = torch.sin(a0)[:, None]
        x1 = ca * pat[None, :, 0] - sa * pat[None, :, 1] + x0
        y1 = sa * pat[None, :, 0] + ca * pat[None, :, 1] + y0
        x2 = ca * pat[None, :, 2] - sa * pat[None, :, 3] + x0
        y2 = sa * pat[None, :, 2] + ca * pat[None, :, 3] + y0
        out.append((_bilinear(im, x1, y1) < _bilinear(im, x2, y2)).to(torch.uint8))
    return torch.cat(out)


def orb_features(
    images: torch.Tensor,  # (B, H, W) float [0, 1] or uint8
    max_features: int = 2048,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    threshold: float = 0.08,
    subpixel: bool = True,
) -> dict:
    """Full batched ORB on the device of `images`. Returns a dict with
    keypoints (B, F, 2), angle, response, scale, valid (B, F) and
    descriptors (B, F, 32) packed uint8, F = max_features.

    subpixel=False gives the JAX package's keypoints: whole pixels of their
    level times 1.2^level. subpixel=True (the CLI's) refines each to its
    Harris peak (`_peak_offsets`) and maps level pixel centres to the image
    through the level's true size: (x + 0.5) * W / W_level - 0.5. Only the
    keypoints differ; orientation and descriptors are sampled at the whole
    pixels either way. Coarse levels carry most corners on smooth textures
    (levels 4-7 hold ~3/4 of them at the texel scale of the 1080p render of
    utils/synth.py), and there a whole level pixel is 2.1-3.6 image pixels.

    Spans (utils/stage_timer.py, non-synchronising): "orb detect" holds
    each level's FAST test, Harris response, selection, keypoints and the
    next level's resize, and the final selection over the levels; "orb
    describe" each level's orientation and BRIEF bits, and the packing."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    b, h, w = images.shape
    border = _PATCH // 2 + 2
    dev = images.device

    per_level = []
    cur = images
    for lev in range(n_levels):
        hl, wl = cur.shape[-2:]
        if min(hl, wl) < 2 * border + 8:
            break
        with stage("orb detect"):
            harris = _harris(cur)
            score = _nms3x3(_score(_fast_corners(cur, threshold), harris))
            yy = torch.arange(hl, device=dev)[:, None]
            xx = torch.arange(wl, device=dev)[None, :]
            inb = (yy >= border) & (yy < hl - border) & (xx >= border) & (xx < wl - border)
            score = torch.where(inb[None], score, torch.full_like(score, float("-inf")))

            k_lev = min(max(max_features // max(1, lev + 1), 64), hl * wl)
            vals, idx = select_top_k(score.reshape(b, -1), k_lev)
            ys = torch.div(idx, wl, rounding_mode="floor").to(torch.float32)
            xs = (idx % wl).to(torch.float32)
            valid = torch.isfinite(vals)

            lvl_scale = scale_factor**lev
            if subpixel:
                ox, oy = _peak_offsets(harris, xs, ys)
                kps = torch.stack([(xs + ox + 0.5) * (w / wl) - 0.5,
                                   (ys + oy + 0.5) * (h / hl) - 0.5], dim=-1)
            else:
                kps = torch.stack([xs, ys], dim=-1) * lvl_scale
            nh = int(round(cur.shape[-2] / scale_factor))
            nw = int(round(cur.shape[-1] / scale_factor))
            nxt = resize_linear(cur, nh, nw)

        with stage("orb describe"):
            ang = torch.stack([_orientation(cur[i], xs[i], ys[i]) for i in range(b)])
            blurred = gaussian_blur(cur, 2.0)  # classic BRIEF smoothing
            bits = torch.stack([_brief(blurred[i], xs[i], ys[i], ang[i]) for i in range(b)])

        per_level.append({
            "keypoints": kps,
            "angle": ang,
            "response": torch.where(valid, vals, torch.full_like(vals, float("-inf"))),
            "scale": torch.full_like(ang, lvl_scale),
            "valid": valid,
            "bits": bits,
        })
        cur = nxt

    with stage("orb detect"):
        merged = {k: torch.cat([p[k] for p in per_level], dim=1) for k in per_level[0]}
        score = torch.where(merged["valid"], merged["response"],
                            torch.full_like(merged["response"], float("-inf")))
        _, top = select_top_k(score, max_features)

        def take(a):
            return torch.gather(a, 1, top.reshape(b, -1, *([1] * (a.dim() - 2))).expand(
                -1, -1, *a.shape[2:]))

        out = {k: take(merged[k]) for k in ("keypoints", "angle", "response", "scale")}
        out["valid"] = take(merged["valid"]) & torch.isfinite(take(score))
    with stage("orb describe"):
        out["descriptors"] = packbits_little(take(merged["bits"]))
    return out
