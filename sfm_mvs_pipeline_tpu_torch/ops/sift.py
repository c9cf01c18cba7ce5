"""Batched SIFT detection + description on tensors.

Port of sfm_mvs_pipeline_tpu/ops/sift.py, the stand-in for the reference's
cv::SIFT::create(featureLimit, 3, 0.09) frontend (ref:
PhotogrammetrieCli.cpp:342-357, SfM.cpp:577-597). A batch of images runs
through one pipeline with a fixed feature capacity F and validity masks:

  images (B, H, W) -> keypoints (B, F, 2), scale/angle/response (B, F),
                      valid (B, F), descriptors (B, F, 128)

Algorithm (Lowe SIFT, OpenCV-flavoured): optional 2x upsample, Gaussian
pyramid (3 layers, sigma0 1.6), DoG extrema over 3x3x3 neighbourhoods,
one-step quadratic refinement with contrast and edge rejection, top-k
candidate selection, a 36-bin orientation histogram with a secondary
orientation (>= 0.8 of the peak) and the 4x4x8 descriptor normalised,
clipped at 0.2 and scaled to 512. Arithmetic follows the JAX package op
for op (same blur taps and summation order, same sample grids) so the
two agree to float rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from sfm_mvs_pipeline_tpu_torch.ops.topk import select_top_k


# ---------------------------------------------------------------- gaussians
def _gauss_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W) with edge replication, taps
    summed in the JAX package's order (first tap first)."""
    if sigma <= 0:
        return img
    k = _gauss_kernel1d(sigma)
    r = (len(k) - 1) // 2
    h, w = img.shape[-2:]
    p = TF.pad(img[:, None], (0, 0, r, r), mode="replicate")[:, 0]
    out = None
    for i, ki in enumerate(k):
        term = p[:, i : i + h, :] * float(ki)
        out = term if out is None else out + term
    p = TF.pad(out[:, None], (r, r, 0, 0), mode="replicate")[:, 0]
    out = None
    for i, ki in enumerate(k):
        term = p[:, :, i : i + w] * float(ki)
        out = term if out is None else out + term
    return out


def _resize_half(img: torch.Tensor) -> torch.Tensor:
    return img[:, ::2, ::2]


def _resize_double(img: torch.Tensor) -> torch.Tensor:
    """2x linear upsample with half-pixel centres (jax.image.resize
    'linear'); the edge taps renormalise to the edge pixel."""
    return TF.interpolate(
        img[:, None], scale_factor=2, mode="bilinear", align_corners=False
    )[:, 0]


# ---------------------------------------------------------------- pyramid
def build_pyramid(
    img: torch.Tensor,
    n_octaves: int,
    n_layers: int = 3,
    sigma0: float = 1.6,
    upsample: bool = True,
    assumed_blur: float = 0.5,
):
    """Returns (gaussians, dogs): per-octave (B, L+3, Ho, Wo) / (B, L+2, Ho, Wo)."""
    if upsample:
        base = _resize_double(img)
        delta = math.sqrt(max(sigma0**2 - (2 * assumed_blur) ** 2, 0.01))
    else:
        base = img
        delta = math.sqrt(max(sigma0**2 - assumed_blur**2, 0.01))
    base = gaussian_blur(base, delta)

    k = 2.0 ** (1.0 / n_layers)
    sig_prev = sigma0
    sig_incr = []
    for i in range(1, n_layers + 3):
        sig_total = sigma0 * (k**i)
        sig_incr.append(math.sqrt(sig_total**2 - sig_prev**2))
        sig_prev = sig_total

    gaussians, dogs = [], []
    cur = base
    for _ in range(n_octaves):
        levels = [cur]
        g = cur
        for s in sig_incr:
            g = gaussian_blur(g, s)
            levels.append(g)
        G = torch.stack(levels, dim=1)
        gaussians.append(G)
        dogs.append(G[:, 1:] - G[:, :-1])
        cur = _resize_half(levels[n_layers])
    return gaussians, dogs


# ---------------------------------------------------------------- extrema
def _find_octave_extrema(
    dog: torch.Tensor,  # (B, L+2, H, W)
    contrast_threshold: float,
    edge_threshold: float,
    n_layers: int,
    k_oct: int,
):
    """Detect + refine extrema in one octave. Returns a dict of (B, k_oct)
    tensors: x, y (octave pixels, subpixel), layer, off_s, response, valid."""
    b, L2, h, w = dog.shape
    prefilter = 0.5 * contrast_threshold / n_layers
    mx = TF.max_pool3d(dog[:, None], 3, stride=1, padding=1)[:, 0]
    mn = -TF.max_pool3d(-dog[:, None], 3, stride=1, padding=1)[:, 0]
    is_ext = ((dog >= mx) | (dog <= mn)) & (torch.abs(dog) > prefilter)
    border = 5  # OpenCV SIFT_IMG_BORDER; only the middle layers
    dev = dog.device
    li_ = torch.arange(L2, device=dev)[:, None, None]
    yi_ = torch.arange(h, device=dev)[None, :, None]
    xi_ = torch.arange(w, device=dev)[None, None, :]
    keep = (
        (li_ >= 1) & (li_ < L2 - 1) & (yi_ >= border) & (yi_ < h - border)
        & (xi_ >= border) & (xi_ < w - border)
    )
    is_ext = is_ext & keep[None]

    score = torch.where(is_ext, torch.abs(dog), torch.zeros_like(dog))
    vals, idx = select_top_k(score.reshape(b, -1), k_oct)
    valid = vals > 0

    li = idx // (h * w)
    rem = idx % (h * w)
    yi = rem // w
    xi = rem % w
    flat = dog.reshape(b, -1)

    def grab(dl, dy, dx):
        ll = torch.clamp(li + dl, 0, L2 - 1)
        yy = torch.clamp(yi + dy, 0, h - 1)
        xx = torch.clamp(xi + dx, 0, w - 1)
        return torch.gather(flat, 1, (ll * h + yy) * w + xx)

    D = grab(0, 0, 0)
    dx_ = (grab(0, 0, 1) - grab(0, 0, -1)) * 0.5
    dy_ = (grab(0, 1, 0) - grab(0, -1, 0)) * 0.5
    ds_ = (grab(1, 0, 0) - grab(-1, 0, 0)) * 0.5
    dxx = grab(0, 0, 1) + grab(0, 0, -1) - 2 * D
    dyy = grab(0, 1, 0) + grab(0, -1, 0) - 2 * D
    dss = grab(1, 0, 0) + grab(-1, 0, 0) - 2 * D
    dxy = (grab(0, 1, 1) - grab(0, 1, -1) - grab(0, -1, 1) + grab(0, -1, -1)) * 0.25
    dxs = (grab(1, 0, 1) - grab(1, 0, -1) - grab(-1, 0, 1) + grab(-1, 0, -1)) * 0.25
    dys = (grab(1, 1, 0) - grab(1, -1, 0) - grab(-1, 1, 0) + grab(-1, -1, 0)) * 0.25

    H = torch.stack(
        [
            torch.stack([dxx, dxy, dxs], -1),
            torch.stack([dxy, dyy, dys], -1),
            torch.stack([dxs, dys, dss], -1),
        ],
        -2,
    )
    g = torch.stack([dx_, dy_, ds_], -1)
    Hr = H + 1e-6 * torch.eye(3, dtype=dog.dtype, device=dev)
    off = -torch.linalg.solve_ex(Hr, g[..., None])[0][..., 0]
    off = torch.clamp(off, -0.5, 0.5)

    contrast = D + 0.5 * torch.sum(g * off, dim=-1)
    valid = valid & (torch.abs(contrast) * n_layers >= contrast_threshold)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_threshold
    valid = valid & (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    return {
        "x": xi.to(dog.dtype) + off[..., 0],
        "y": yi.to(dog.dtype) + off[..., 1],
        "layer": li,
        "off_s": off[..., 2],
        "response": torch.abs(contrast),
        "valid": valid,
    }


# ------------------------------------------------------- orientation + desc
def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W) image at float coordinates x, y (any
    shape), zero padding outside the image: the JAX package's
    ops/sift.py::_bilinear on one plane, corners summed in its order."""
    h, w = img.shape[-2:]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape(-1)

    def at(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = flat[yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)]
        return torch.where(inside, v, torch.zeros_like(v))

    return (
        at(y0i, x0i) * (1 - fx) * (1 - fy)
        + at(y0i, x0i + 1) * fx * (1 - fy)
        + at(y0i + 1, x0i) * (1 - fx) * fy
        + at(y0i + 1, x0i + 1) * fx * fy
    )


_ORI_GRID = 8  # samples per side for the orientation histogram
_DESC_GRID = 16  # samples per side for the descriptor
_N_ORI_BINS = 36


def _one_hot(i: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return TF.one_hot(i.long(), n).to(dtype)


def _keypoint_orientation(samp, x, y, sigma_rel, dtype):
    """Dominant (and secondary) gradient orientation. samp(sx, sy) samples
    (B, K, n) from each keypoint's own pyramid plane; x, y, sigma_rel (B, K).
    Returns (angle, angle2, has2), each (B, K)."""
    dev = x.device
    lin = torch.arange(-_ORI_GRID, _ORI_GRID + 1, dtype=dtype, device=dev)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)
    step = (3.0 * 1.5) / _ORI_GRID * sigma_rel
    sx = x[..., None] + gx * step[..., None]
    sy = y[..., None] + gy * step[..., None]

    dxs = samp(sx + 1, sy) - samp(sx - 1, sy)
    dys = samp(sx, sy + 1) - samp(sx, sy - 1)
    mag = torch.sqrt(dxs * dxs + dys * dys)
    theta = torch.atan2(dys, dxs)
    r2 = (gx * gx + gy * gy) / (_ORI_GRID / 2.0) ** 2
    wgt = torch.exp(-r2) * mag

    bins = torch.remainder(theta / (2 * math.pi) * _N_ORI_BINS, _N_ORI_BINS)
    b0 = torch.remainder(torch.floor(bins).long(), _N_ORI_BINS)
    f = bins - torch.floor(bins)
    oh0 = _one_hot(b0, _N_ORI_BINS, dtype) * ((1 - f) * wgt)[..., None]
    oh1 = _one_hot((b0 + 1) % _N_ORI_BINS, _N_ORI_BINS, dtype) * (f * wgt)[..., None]
    hist = torch.sum(oh0 + oh1, dim=-2)  # (B, K, 36)
    # circular [1 4 6 4 1]/16 smoothing, as OpenCV applies once
    kern = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]
    histp = torch.cat([hist[..., -2:], hist, hist[..., :2]], dim=-1)
    sm = None
    for i, kv in enumerate(kern):
        term = histp[..., i : i + _N_ORI_BINS] * kv
        sm = term if sm is None else sm + term
    hist = sm

    def refine_angle(peak):
        hp = torch.gather(hist, -1, ((peak - 1) % _N_ORI_BINS)[..., None])[..., 0]
        hc = torch.gather(hist, -1, peak[..., None])[..., 0]
        hn = torch.gather(hist, -1, ((peak + 1) % _N_ORI_BINS)[..., None])[..., 0]
        denom = hp - 2 * hc + hn
        delta = torch.where(
            torch.abs(denom) > 1e-12, 0.5 * (hp - hn) / denom, torch.zeros_like(denom)
        )
        ang_bin = peak.to(dtype) + torch.clamp(delta, -0.5, 0.5)
        return (ang_bin / _N_ORI_BINS) * 2 * math.pi

    peak = torch.argmax(hist, dim=-1)
    hmax = torch.amax(hist, dim=-1)
    left = torch.roll(hist, 1, dims=-1)
    right = torch.roll(hist, -1, dims=-1)
    bins_i = torch.arange(_N_ORI_BINS, device=dev)
    is_peak = (hist > left) & (hist >= right) & (bins_i != peak[..., None])
    sec_score = torch.where(
        is_peak & (hist >= 0.8 * hmax[..., None]), hist, torch.full_like(hist, -1.0)
    )
    peak2 = torch.argmax(sec_score, dim=-1)
    has2 = torch.amax(sec_score, dim=-1) > 0
    return refine_angle(peak), refine_angle(peak2), has2


def _spatial_weights(dtype, device) -> torch.Tensor:
    """(n*n, 16) static bilinear weights of each descriptor sample into the
    4x4 spatial bins."""
    d, n = 4, _DESC_GRID
    lin = (np.arange(n, dtype=np.float64) + 0.5) / n * d - d / 2.0
    gy, gx = np.meshgrid(lin.astype(np.float32), lin.astype(np.float32), indexing="ij")
    bx = gx.ravel() + np.float32(d / 2.0 - 0.5)
    by = gy.ravel() + np.float32(d / 2.0 - 0.5)
    x0, y0 = np.floor(bx), np.floor(by)
    fx, fy = bx - x0, by - y0
    cols = []
    for iy in range(d):
        for ix in range(d):
            wx = np.where(ix == x0, 1 - fx, np.where(ix == x0 + 1, fx, 0.0))
            wy = np.where(iy == y0, 1 - fy, np.where(iy == y0 + 1, fy, 0.0))
            cols.append((wx * wy).astype(np.float32))
    return torch.as_tensor(np.stack(cols, -1), dtype=dtype, device=device)


def _keypoint_descriptor(samp, x, y, sigma_rel, angle, dtype):
    """Classic 4x4x8 SIFT descriptor. Returns (B, K, 128)."""
    d, n = 4, _DESC_GRID
    dev = x.device
    lin = (torch.arange(n, dtype=dtype, device=dev) + 0.5) / n * d - d / 2.0
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)
    bin_w = 3.0 * sigma_rel
    ca = torch.cos(angle)
    sa = torch.sin(angle)
    px = (ca[..., None] * gx - sa[..., None] * gy) * bin_w[..., None] + x[..., None]
    py = (sa[..., None] * gx + ca[..., None] * gy) * bin_w[..., None] + y[..., None]

    dxs = samp(px + 1, py) - samp(px - 1, py)
    dys = samp(px, py + 1) - samp(px, py - 1)
    mag = torch.sqrt(dxs * dxs + dys * dys)
    theta = torch.atan2(dys, dxs) - angle[..., None]
    r2 = (gx * gx + gy * gy) / (2 * (d / 2.0) ** 2)
    wgt = torch.exp(-r2) * mag  # (B, K, n*n)

    Wsp = _spatial_weights(dtype, dev)
    nb = 8
    ob = torch.remainder(theta / (2 * math.pi) * nb, nb)
    o0 = torch.remainder(torch.floor(ob).long(), nb)
    fo = ob - torch.floor(ob)
    Wo = _one_hot(o0, nb, dtype) * (1 - fo)[..., None] + _one_hot(
        (o0 + 1) % nb, nb, dtype
    ) * fo[..., None]  # (B, K, n*n, 8)
    desc = torch.einsum("bkn,ns,bkno->bkso", wgt, Wsp, Wo)
    desc = desc.reshape(desc.shape[0], desc.shape[1], 128)
    # OpenCV normalisation: L2 -> clip 0.2 -> L2 -> scale 512
    norm = torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-12
    desc = torch.clamp(desc / norm, max=0.2)
    norm = torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-12
    return desc / norm * 512.0


# ---------------------------------------------------------------- pipeline
def _sift_detect(images, max_features, n_layers, contrast_threshold,
                 edge_threshold, upsample, n_octaves):
    """Phase 1: pyramid + extrema + global candidate selection. Returns
    (gaussians, cand dict of (B, F) tensors in octave coordinates)."""
    gaussians, dogs = build_pyramid(images, n_octaves, n_layers, upsample=upsample)
    sigma0 = 1.6
    per_oct = []
    for o in range(n_octaves):
        ext = _find_octave_extrema(
            dogs[o], contrast_threshold, edge_threshold, n_layers, max_features
        )
        layer_f = ext["layer"].to(images.dtype) + ext["off_s"]
        per_oct.append(
            {
                "x": ext["x"],
                "y": ext["y"],
                "layer": ext["layer"],
                "sigma_rel": sigma0 * (2.0 ** (layer_f / n_layers)),
                "response": ext["response"],
                "valid": ext["valid"],
                "octave": torch.full_like(ext["layer"], o),
            }
        )
    merged = {k: torch.cat([p[k] for p in per_oct], dim=1) for k in per_oct[0]}
    # global top-F by response: valid candidates sort ahead of the padding
    score = torch.where(
        merged["valid"], merged["response"], torch.full_like(merged["response"], -1.0)
    )
    _, top = select_top_k(score, max_features)
    cand = {k: torch.gather(v, 1, top) for k, v in merged.items()}
    cand["n_valid"] = torch.sum(merged["valid"], dim=1)
    return gaussians, cand


def _sift_describe_flat(flat, xs, ys, lvl, sig, base, h_o, w_o):
    """Phase 2, all octaves at once: each keypoint samples its own plane of
    the per-image flattened pyramid `flat` (B, T) through per-keypoint
    (base, H, W) offsets. xs/ys/lvl/sig/base/h_o/w_o: (B, K)."""
    Hk = h_o[..., None]
    Wk = w_o[..., None]
    lk = lvl[..., None]
    bk = base[..., None]
    b = flat.shape[0]

    def samp(sx, sy):
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        fx = sx - x0
        fy = sy - y0
        x0i = x0.long()
        y0i = y0.long()

        def at(yy, xx):
            inside = (yy >= 0) & (yy < Hk) & (xx >= 0) & (xx < Wk)
            yc = torch.minimum(torch.clamp(yy, min=0), Hk - 1)
            xc = torch.minimum(torch.clamp(xx, min=0), Wk - 1)
            idx = bk + (lk * Hk + yc) * Wk + xc
            v = torch.gather(flat, 1, idx.reshape(b, -1)).reshape(idx.shape)
            return torch.where(inside, v, torch.zeros_like(v))

        return (
            at(y0i, x0i) * (1 - fx) * (1 - fy)
            + at(y0i, x0i + 1) * fx * (1 - fy)
            + at(y0i + 1, x0i) * (1 - fx) * fy
            + at(y0i + 1, x0i + 1) * fx * fy
        )

    ang, ang2, has2 = _keypoint_orientation(samp, xs, ys, sig, flat.dtype)
    descs = _keypoint_descriptor(samp, xs, ys, sig, ang, flat.dtype)
    descs2 = _keypoint_descriptor(samp, xs, ys, sig, ang2, flat.dtype)
    return ang, descs, ang2, descs2, has2


def sift_features(
    images: torch.Tensor,  # (B, H, W) float in [0, 1] (or uint8)
    max_features: int = 2048,
    n_layers: int = 3,
    contrast_threshold: float = 0.04,
    edge_threshold: float = 10.0,
    upsample: bool = True,
) -> dict:
    """Full batched SIFT. Returns a dict of tensors on the images' device:
    keypoints (B, F, 2) in original pixels, scale, angle, response,
    valid (B, F), descriptors (B, F, 128).

    Two phases: detection ranks candidates globally; the host reads the
    detected count and sizes the describe phase to the next power of two,
    so orientation/descriptor work scales with detected features."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    b, h, w = images.shape
    base_dim = min(h, w) * (2 if upsample else 1)
    n_octaves = max(1, int(math.floor(math.log2(base_dim / 16))))

    gaussians, cand = _sift_detect(
        images, max_features, n_layers, contrast_threshold, edge_threshold,
        upsample, n_octaves,
    )
    n_valid = int(torch.max(cand["n_valid"]))
    k_sel = 128
    while k_sel < min(n_valid, max_features):
        k_sel *= 2
    k_sel = min(k_sel, max_features)
    cand_k = {k: v[:, :k_sel] for k, v in cand.items() if k != "n_valid"}
    F = max_features

    dev = images.device
    sizes = [int(np.prod(g.shape[1:])) for g in gaussians]
    off_tab = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)])[:-1], device=dev)
    h_tab = torch.as_tensor([g.shape[2] for g in gaussians], device=dev)
    w_tab = torch.as_tensor([g.shape[3] for g in gaussians], device=dev)
    flat = torch.cat([g.reshape(b, -1) for g in gaussians], dim=1)

    valid_k = cand_k["valid"]
    oct_k = torch.clamp(cand_k["octave"], 0, n_octaves - 1)
    nlev = gaussians[0].shape[1]
    xs = torch.where(valid_k, cand_k["x"], torch.full_like(cand_k["x"], 16.0))
    ys = torch.where(valid_k, cand_k["y"], torch.full_like(cand_k["y"], 16.0))
    lvl_k = torch.clamp(cand_k["layer"], 0, nlev - 1)
    ang_k, desc_k, ang2_k, desc2_k, has2_k = _sift_describe_flat(
        flat, xs, ys, lvl_k, cand_k["sigma_rel"],
        off_tab[oct_k], h_tab[oct_k], w_tab[oct_k],
    )

    # secondary orientation peaks >= 0.8 * max emit a second keypoint at the
    # same location (cv::SIFT parity); primaries + secondaries are pooled and
    # the F capacity filled by response like the reference's retainBest
    scale_k = (2.0 ** cand_k["octave"].to(images.dtype)) / (2.0 if upsample else 1.0)
    kp_k = torch.stack([cand_k["x"], cand_k["y"]], -1) * scale_k[..., None]
    valid2 = valid_k & has2_k

    def pool(a, b2):
        return torch.cat([a, b2], dim=1)

    zero = torch.zeros((), dtype=images.dtype, device=dev)
    p_kp = pool(kp_k, kp_k)
    p_scale = pool(cand_k["sigma_rel"] * scale_k, cand_k["sigma_rel"] * scale_k)
    p_resp = pool(cand_k["response"], cand_k["response"])
    p_ang = pool(torch.where(valid_k, ang_k, zero), torch.where(valid2, ang2_k, zero))
    p_desc = pool(
        torch.where(valid_k[..., None], desc_k, zero),
        torch.where(valid2[..., None], desc2_k, zero),
    )
    p_valid = pool(valid_k, valid2)

    if 2 * k_sel <= F:
        def place(x):
            out = torch.zeros((b, F) + tuple(x.shape[2:]), dtype=x.dtype, device=dev)
            out[:, : 2 * k_sel] = x
            return out
    else:
        # top-F by response among valid pooled slots (retainBest counts
        # orientation duplicates toward the feature limit too)
        score = torch.where(p_valid, p_resp, torch.full_like(p_resp, -1.0))
        sel = torch.sort(score, dim=1, descending=True, stable=True)[1][:, :F]

        def place(x):
            ix = sel.reshape(sel.shape + (1,) * (x.dim() - 2)).expand(
                (b, F) + tuple(x.shape[2:])
            )
            return torch.gather(x, 1, ix)

    return {
        "keypoints": place(p_kp),
        "scale": place(p_scale),
        "angle": place(p_ang),
        "response": place(p_resp),
        "valid": place(p_valid),
        "descriptors": place(p_desc),
    }
