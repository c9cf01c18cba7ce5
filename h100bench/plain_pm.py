"""A plain PyTorch reference of the port's rectified PatchMatch and its
cross-neighbour consensus (`-Pdense-method=patchmatch` on a view whose
neighbours' geometry admits rectification), written from the stated
semantics, not from the port.

It imports neither jax, the JAX package nor the port, and runs every step
in plain torch loops (over neighbours, candidate maps, iterations and
window offsets; vectorised over pixels) in float32 with TF32 off. The
tests (tests/test_torch_pm_plain.py) load this file; the comparison on the
card runs it beside the port at 1080p.

Semantics (the port's mvs/patchmatch.py::patchmatch_rect_depth):
  * cameras: intrinsics (f, cx, cy, ...) with K = [[f, 0, cx], [0, f, cy],
    [0, 0, 1]] (the images already undistorted), poses (angle-axis, t)
    world to camera, R by Rodrigues' formula, centre C = -R^T t;
  * rectification of a (ref, neighbour) pair (Fusiello, world frame):
    e1 = (C_n - C_r) / b, e2 = (r3 x e1) / |r3 x e1| with r3 the ref's
    optical axis, e3 = e1 x e2; the pair is usable when b > 1e-9 and
    |r3 x e1| > 0.3. Each image is resampled through the homography
    K [e1; e2; e3] R^T K^-1 (pixel -> rectified pixel), inverted: the
    source point of each rectified pixel, its third coordinate kept away
    from 0 (|z| < 1e-9 -> 1e-9), sampled bilinearly with clamped taps; a
    sample is inside when 0 <= x <= W - 1.001 and 0 <= y <= H - 1.001;
  * the reference's window statistics: mean and variance (clamped at
    1e-8) over the (2r+1)^2 window, the rectified reference edge-replicated;
  * a candidate disparity d = di + frac (di = floor(d)) at pixel (y, x)
    scores, over dy, o in [-r, r] (dy outer, o inner),
        s = (1 - frac) n[y', x + o - di] + frac n[y', x + o - di - 1]
    (y' = y + dy clamped to the image; n the rectified neighbour with its
    outside pixels zeroed, 0 outside [0, W)) against the reference's
    taps ref[y', x + o] (0 outside [0, W)): sums of s, s^2 and ref s,
    then n_var = max(E[s^2] - E[s]^2, 1e-8), zncc = (E[ref s] - r_mean
    E[s]) / sqrt(max(r_var, 1e-8) n_var), cost (1 - clip(zncc, -1, 1)) / 2;
    cost 1 where either centre tap (x - di, x - di - 1) lies outside the
    neighbour, and where the reference's rectified pixel is outside;
  * per pair, disparities in [d_lo, d_hi] = [f b / z_max, min(f b / z_min,
    max_disp)], span = max(d_hi - d_lo, 1e-3): d = d_lo + span u0, every
    pixel scored; then for each iteration `it` (scale span 0.5^(it + 1))
    and each checkerboard parity p in (0, 1), with draws (u_local,
    u_full), six candidates: the four neighbours' d (above, below, left,
    right; edge-replicated), d + scale (2 u_local - 1), d_lo + span u_full,
    each clipped to [d_lo, d_hi]. The first candidate of least cost
    replaces d where (y + x) % 2 == p and its cost is below the pixel's;
  * back to the reference frame: inverse depth d / max(f b, 1e-9), the
    cost and the validity (cost <= max_cost, usable pair) sampled
    bilinearly at each reference pixel's rectified position; the depth
    z_rect K^-1 q turned into the reference camera's frame; valid where
    the sample is inside, the sampled validity > 0.999, the depth > 1e-6
    and the pair usable;
  * consensus over the neighbours (padded slots: depth 0, cost 1,
    invalid): each valid neighbour's support is the count of valid
    neighbours within 2% of its depth; the first of the highest support,
    less cost, wins; the depth is the mean of the neighbours within 2% of
    the winner's; valid where a neighbour is valid, at least min(2, valid
    neighbours) support it and the winner's cost <= max_cost.

Random draws are given, one (u0, [(u_local, u_full), ...]) a neighbour,
each (H, W), in the order they are used; patchmatch_rect_depth(draws=...)
accepts the same. Left out, as the cell never takes them: the warp-based
PatchMatch of views whose every neighbour fails the rectification gate
(the cell's `pm_rect_view_pct` reads 100 where no view does), and drawing
from a generator. `score_dtype` computes the candidate scoring (K3's part)
in another precision, for the control: bfloat16 must fail the comparison.

The reference's window statistics are direct sums over the window; the
port's come from cumulative sums, which round differently. PatchMatch's
search amplifies that rounding wherever two candidates' costs agree to it
(an argmin, or `cbest < cost`, resolves the other way and the states drift
apart), so the two agree on most depths within 1% rather than bit for bit.
`stats` hands in another window-statistics function: given the port's,
the reference is bit-equal to the port on the CPU, which pins every other
step exactly.
"""

from __future__ import annotations

import contextlib

import torch

F32 = torch.float32


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for matmuls and convolutions inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """(3,) angle-axis -> (3, 3) rotation: I + sin(t)/t K + (1 - cos t)/t^2 K^2,
    t^2 the sum of squares (series terms below t^2 = 1e-8)."""
    theta2 = (aa * aa).sum()
    if float(theta2) < 1e-8:
        a, b = 1.0 - theta2 / 6.0, 0.5 - theta2 / 24.0
    else:
        theta = torch.sqrt(theta2)
        a, b = torch.sin(theta) / theta, (1.0 - torch.cos(theta)) / theta2
    x, y, z = aa
    zero = torch.zeros((), dtype=aa.dtype, device=aa.device)
    k = torch.stack([torch.stack([zero, -z, y]), torch.stack([z, zero, -x]),
                     torch.stack([-y, x, zero])])
    return torch.eye(3, dtype=aa.dtype, device=aa.device) + a * k + b * (k @ k)


def camera_matrix(intr: torch.Tensor) -> torch.Tensor:
    f, cx, cy = intr[0], intr[1], intr[2]
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    return torch.stack([torch.stack([f, zero, cx]), torch.stack([zero, f, cy]),
                        torch.stack([zero, zero, one])])


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """img sampled at (x, y) with clamped taps; (values, inside)."""
    h, w = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xi, yi = x0.long(), y0.long()

    def tap(yy, xx):
        return img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

    v = (tap(yi, xi) * (1 - fx) * (1 - fy) + tap(yi, xi + 1) * fx * (1 - fy)
         + tap(yi + 1, xi) * (1 - fx) * fy + tap(yi + 1, xi + 1) * fx * fy)
    inside = (x >= 0) & (x <= w - 1.001) & (y >= 0) & (y <= h - 1.001)
    return v, inside


def apply_homography(Hm: torch.Tensor, h: int, w: int):
    """(x, y) (H, W) of every pixel mapped through Hm."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=Hm.dtype, device=Hm.device),
                            torch.arange(w, dtype=Hm.dtype, device=Hm.device), indexing="ij")
    p = Hm @ torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    z = torch.where(p[2].abs() < 1e-9, torch.full_like(p[2], 1e-9), p[2])
    return (p[0] / z).reshape(h, w), (p[1] / z).reshape(h, w)


def rectify(ref, nbr, pose_r, pose_n, intr) -> dict:
    """The pair's rectified images, masks and frame."""
    h, w = ref.shape
    K = camera_matrix(intr)
    Kinv = torch.linalg.inv(K)
    R_r, R_n = rodrigues(pose_r[:3]), rodrigues(pose_n[:3])
    C_r, C_n = -R_r.T @ pose_r[3:], -R_n.T @ pose_n[3:]
    base = C_n - C_r
    b = torch.linalg.norm(base)
    e1 = base / torch.clamp(b, min=1e-12)
    c2 = torch.linalg.cross(R_r[2], e1)
    n2 = torch.linalg.norm(c2)
    e2 = c2 / torch.clamp(n2, min=1e-12)
    R_R = torch.stack([e1, e2, torch.linalg.cross(e1, e2)])
    H_ref = K @ R_R @ R_r.T @ Kinv
    H_nbr = K @ R_R @ R_n.T @ Kinv
    ref_rect, in_r = bilinear(ref, *apply_homography(torch.linalg.inv(H_ref), h, w))
    nbr_rect, in_n = bilinear(nbr, *apply_homography(torch.linalg.inv(H_nbr), h, w))
    return {"K": K, "Kinv": Kinv, "R_r": R_r, "R_R": R_R, "b": b, "H_ref": H_ref,
            "usable": bool(b > 1e-9) and bool(n2 > 0.3),
            "ref": ref_rect, "in_r": in_r, "nbr": nbr_rect, "in_n": in_n}


def window_stats(img: torch.Tensor, r: int):
    """Mean and variance (clamped at 1e-8) over the (2r+1)^2 window, the
    image edge-replicated."""
    h, w = img.shape
    area = float((2 * r + 1) ** 2)
    rows, cols = torch.arange(h, device=img.device), torch.arange(w, device=img.device)
    s = torch.zeros_like(img)
    ss = torch.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            t = img[(rows + dy).clamp(0, h - 1)][:, (cols + dx).clamp(0, w - 1)]
            s = s + t
            ss = ss + t * t
    mean = s / area
    return mean, torch.clamp(ss / area - mean * mean, min=1e-8)


def score(cand, fr: dict, r_mean, r_var, r: int, dtype=F32) -> torch.Tensor:
    """Cost (H, W) of one candidate disparity map (module doc), computed in
    `dtype` and returned as float32."""
    h, w = cand.shape
    dev = cand.device
    nbr = torch.where(fr["in_n"], fr["nbr"], torch.zeros((), dtype=F32, device=dev)).to(dtype)
    ref = fr["ref"].to(dtype)
    di = torch.floor(cand)
    frac = (cand - di).to(dtype)
    di = di.long()
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]

    def tap(img, yy, xx):
        ok = (xx >= 0) & (xx < w)
        v = img[yy.expand(h, w), xx.clamp(0, w - 1).expand(h, w)]
        return torch.where(ok, v, torch.zeros((), dtype=dtype, device=dev))

    sn = torch.zeros((h, w), dtype=dtype, device=dev)
    snn = torch.zeros_like(sn)
    srn = torch.zeros_like(sn)
    for dy in range(-r, r + 1):
        yy = (rows + dy).clamp(0, h - 1)
        for o in range(-r, r + 1):
            s = ((1 - frac) * tap(nbr, yy, cols + o - di) + frac * tap(nbr, yy, cols + o - di - 1))
            sn = sn + s
            snn = snn + s * s
            srn = srn + tap(ref, yy, cols + o) * s
    area = torch.tensor(float((2 * r + 1) ** 2), dtype=dtype, device=dev)
    n_mean = sn / area
    n_var = torch.clamp(snn / area - n_mean * n_mean, min=1e-8)
    cov = srn / area - r_mean.to(dtype) * n_mean
    zncc = cov / torch.sqrt(torch.clamp(r_var.to(dtype), min=1e-8) * n_var)
    cost = ((1.0 - torch.clamp(zncc, -1.0, 1.0)) * 0.5).to(F32)
    in_n = fr["in_n"]

    def valid_at(xx):
        ok = (xx >= 0) & (xx < w)
        return ok & in_n[rows.expand(h, w), xx.clamp(0, w - 1)]

    inside = valid_at(cols - di) & valid_at(cols - di - 1) & fr["in_r"]
    return torch.where(inside, cost, torch.ones((), dtype=F32, device=dev))


def _shift(d: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = d[y + dy, x + dx], edge-replicated."""
    h, w = d.shape
    yy = (torch.arange(h, device=d.device) + dy).clamp(0, h - 1)
    xx = (torch.arange(w, device=d.device) + dx).clamp(0, w - 1)
    return d[yy][:, xx]


@_full_fp32()
def pm_rect_pair(ref, nbr, pose_r, pose_n, intr, z_min: float, z_max: float, draws,
                 iterations: int = 8, window_radius: int = 3, max_cost: float = 0.4,
                 max_disp: int = 256, score_dtype=F32, stats=None):
    """(depth, cost, valid) (H, W) in the reference frame of one pair's
    PatchMatch (module doc), with the pair's draws (u0, halves). `stats`
    (img, r) -> (mean, var) replaces window_stats."""
    h, w = ref.shape
    dev = ref.device
    r = window_radius
    fr = rectify(ref, nbr, pose_r, pose_n, intr)
    fb = intr[0] * fr["b"]
    # true divisions: on the card torch divides by a host scalar as a
    # multiply by its reciprocal
    d_lo = fb / torch.tensor(float(z_max), dtype=F32, device=dev)
    d_hi = torch.clamp(fb / torch.tensor(float(z_min), dtype=F32, device=dev),
                       max=float(max_disp))
    span = torch.clamp(d_hi - d_lo, min=1e-3)
    r_mean, r_var = (stats or window_stats)(fr["ref"], r)
    u0, halves = draws
    if len(halves) != 2 * iterations:
        raise ValueError(f"need {2 * iterations} (u_local, u_full) draws, got {len(halves)}")
    d = d_lo + span * torch.as_tensor(u0, dtype=F32, device=dev)
    cost = score(d, fr, r_mean, r_var, r, score_dtype)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    k = 0
    for it in range(iterations):
        scale = span * (0.5 ** (it + 1.0))
        for parity in (0, 1):
            u_local, u_full = (torch.as_tensor(u, dtype=F32, device=dev) for u in halves[k])
            k += 1
            cands = [_shift(d, -1, 0), _shift(d, 1, 0), _shift(d, 0, -1), _shift(d, 0, 1),
                     d + scale * (2.0 * u_local - 1.0), d_lo + span * u_full]
            active = (ys + xs) % 2 == parity
            best_c, best_d = None, None
            for c in cands:
                c = torch.clamp(c, d_lo, d_hi)
                cc = score(c, fr, r_mean, r_var, r, score_dtype)
                if best_c is None:
                    best_c, best_d = cc, c
                else:
                    take = cc < best_c  # the first of equal costs stays
                    best_c = torch.where(take, cc, best_c)
                    best_d = torch.where(take, c, best_d)
            better = active & (best_c < cost)
            d = torch.where(better, best_d, d)
            cost = torch.where(better, best_c, cost)
    iz = d / torch.clamp(fb, min=1e-9)
    val = (cost <= max_cost) & fr["usable"]
    qx, qy = apply_homography(fr["H_ref"], h, w)
    iz_ref, q_in = bilinear(iz, qx, qy)
    v_ref, _ = bilinear(val.to(F32), qx, qy)
    c_ref, _ = bilinear(cost, qx, qy)
    z_rect = 1.0 / torch.clamp(iz_ref, min=1e-9)
    q = torch.stack([qx, qy, torch.ones_like(qx)]).reshape(3, -1)
    X = (fr["Kinv"] @ q) * z_rect.reshape(-1)[None]
    z_ref = ((fr["R_r"] @ fr["R_R"].T) @ X)[2].reshape(h, w)
    valid = q_in & (v_ref > 0.999) & (z_ref > 1e-6) & fr["usable"]
    return z_ref, c_ref, valid


def consensus(depths, costs, valids, rel_tol: float = 0.02, min_support: int = 2,
              max_cost: float = 0.4):
    """(depth, cost, valid) of the neighbours' lists of (H, W) maps."""
    n = len(depths)
    big = 1e30
    d = [torch.where(v, x, torch.full_like(x, big)) for x, v in zip(depths, valids)]
    best_s = best_i = None
    for i in range(n):
        sup = torch.zeros_like(depths[0])
        for j in range(n):
            sup = sup + ((torch.abs(d[j] - d[i]) <= rel_tol * d[i]) & valids[j]
                         & valids[i]).to(sup.dtype)
        s = torch.where(valids[i], sup * 1e3 - costs[i], torch.full_like(sup, -big))
        if best_s is None:
            best_s, best_i = s, torch.zeros(s.shape, dtype=torch.long, device=s.device)
        else:
            take = s > best_s  # the first of equal scores stays
            best_s = torch.where(take, s, best_s)
            best_i = torch.where(take, torch.full_like(best_i, i), best_i)
    d_best = torch.zeros_like(depths[0])
    c_best = torch.zeros_like(depths[0])
    v_best = torch.zeros_like(valids[0])
    for i in range(n):
        at = best_i == i
        d_best = torch.where(at, d[i], d_best)
        c_best = torch.where(at, costs[i], c_best)
        v_best = torch.where(at, valids[i], v_best)
    total = torch.zeros_like(depths[0])
    count = torch.zeros_like(depths[0])
    n_valid = torch.zeros_like(depths[0])
    for i in range(n):
        close = (torch.abs(d[i] - d_best) <= rel_tol * d_best) & valids[i] & v_best
        total = total + torch.where(close, depths[i], torch.zeros_like(total))
        count = count + close.to(count.dtype)
        n_valid = n_valid + valids[i].to(count.dtype)
    depth = total / torch.clamp(count, min=1)
    need = torch.clamp(torch.clamp(n_valid, min=1), max=min_support)
    valid = (n_valid > 0) & (count >= need) & (c_best <= max_cost)
    return depth, c_best, valid


@_full_fp32()
def patchmatch_rect_depth(ref, nbrs, pose_r, poses_n, intr, z_min: float, z_max: float,
                          draws, iterations: int = 8, window_radius: int = 3,
                          max_cost: float = 0.4, max_disp: int = 256, nbr_valid=None,
                          score_dtype=F32, stats=None):
    """(depth, cost, valid) (H, W) of a view from its neighbours (N, H, W):
    each valid slot's pair PatchMatch with its draws, then the consensus."""
    n = nbrs.shape[0]
    ok = [True] * n if nbr_valid is None else [bool(x) for x in nbr_valid]
    depths, costs, valids = [], [], []
    for j in range(n):
        if not ok[j]:
            depths.append(torch.zeros_like(ref))
            costs.append(torch.ones_like(ref))
            valids.append(torch.zeros(ref.shape, dtype=torch.bool, device=ref.device))
            continue
        d, c, v = pm_rect_pair(ref, nbrs[j], pose_r, poses_n[j], intr, z_min, z_max, draws[j],
                               iterations, window_radius, max_cost, max_disp, score_dtype,
                               stats)
        depths.append(d)
        costs.append(c)
        valids.append(v)
    return consensus(depths, costs, valids, max_cost=max_cost, min_support=2)


def compare(d_a, v_a, d_b, v_b, rel: float = 1e-2) -> dict:
    """Agreement of two (depth, valid) results: the share of pixels whose
    validity agrees, and where both are valid the share of depths within
    `rel` relative, the share equal, and the largest relative difference."""
    both = v_a & v_b
    diff = (torch.abs(d_a - d_b) / torch.clamp(torch.abs(d_b), min=1e-12))[both]
    n = diff.numel()
    return {"valid_agree": float((v_a == v_b).float().mean()),
            "both_valid": float(both.float().mean()),
            "depth_agree": float((diff <= rel).float().mean()) if n else 0.0,
            "depth_equal": float((diff == 0).float().mean()) if n else 0.0,
            "max_rel_diff": float(diff.max()) if n else 0.0}
