"""PatchMatch multi-view stereo: `-Pdense-method=patchmatch`.

Port of sfm_mvs_pipeline_tpu/mvs/patchmatch.py, the stand-in for openMVS's
default PatchMatch (ref: src/photogrammetrie/mvs/MVS.cpp:112-120
``DenseReconstruction(0)``). Two formulations, as in the JAX package:

  * `patchmatch_rect_depth`, classic PatchMatch in the RECTIFIED frame of
    each (ref, neighbour) pair (`_pm_rect_pair`): per-pixel continuous
    disparity, random init, 8 iterations of checkerboard propagation from
    the 4 neighbours plus a shrinking local perturbation and a full-range
    draw. Every candidate map is scored by kernel K3
    (ops/kernels/pm_kernel.py, CUDA on the card; `pm_score_rect_plain`
    below is its plain version). The neighbours' results are consensus-
    fused like the rectified sweep's. The JAX package takes this route only
    on its TPU; the port takes it on every device.
  * `patchmatch_depth`, the warp-based, parity-packed form (`_cost_packed`:
    per-pixel projective warp into every neighbour, bilinear taps as
    gathers, mean of the best half of the neighbours). The pipeline keeps
    it for views whose every neighbour fails the rectification geometry
    gate, seeded from the rectified sweep.

Random draws: the JAX package splits `jax.random` keys; here each function
takes a `torch.Generator` (one per neighbour, split from the view's) or the
uniform draws themselves, `(u0, [(u_local, u_full), ...])` with one pair for
each iteration and parity in the order they are used. Tests inject the JAX
package's draws that way; the two generators give different numbers from
the same seed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.models.cameras import intrinsics_to_K
from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat, relative_pose
from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import stage


def _ref_rays(h: int, w: int, K: torch.Tensor, dtype) -> torch.Tensor:
    """(3, H, W) unnormalized camera rays K^-1 [u, v, 1]."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=K.device),
                            torch.arange(w, dtype=dtype, device=K.device), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], 0)
    return torch.einsum("ij,jhw->ihw", torch.linalg.inv(K), pix)


def _shift_edge(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img shifted so out[y, x] = img[y+dy, x+dx], edge-replicated."""
    h, w = img.shape
    yy = (torch.arange(h, device=img.device) + dy).clamp(0, h - 1)
    xx = (torch.arange(w, device=img.device) + dx).clamp(0, w - 1)
    return img[yy][:, xx]


def _row_parity(h: int, parity: int, device) -> torch.Tensor:
    return ((torch.arange(h, device=device) + parity) % 2).reshape(h, 1)


def _pack(x: torch.Tensor, parity: int) -> torch.Tensor:
    """The checkerboard-active half of the trailing (H, W) plane, packed to
    (..., H, W//2): out[..., y, k] = x[..., y, 2k + (parity + y) % 2].
    W must be even (patchmatch_depth pads)."""
    *lead, h, w = x.shape
    x2 = x.reshape(*lead, h, w // 2, 2)
    off = _row_parity(h, parity, x.device)
    return torch.where(off == 0, x2[..., 0], x2[..., 1])


def _unpack_update(full: torch.Tensor, vals: torch.Tensor, parity: int) -> torch.Tensor:
    """Scatter packed (H, W//2) values back into the active slots of full."""
    h, w = full.shape
    f2 = full.reshape(h, w // 2, 2)
    off = _row_parity(h, parity, full.device)
    n0 = torch.where(off == 0, vals, f2[..., 0])
    n1 = torch.where(off == 1, vals, f2[..., 1])
    return torch.stack([n0, n1], dim=-1).reshape(h, w)


def _parity_consts(ref_img: torch.Tensor, rays: torch.Tensor, parity: int, r: int) -> dict:
    """Candidate-invariant per-parity scoring inputs: packed rays, packed
    ref window shifts, and the ref window mean/variance."""
    area = (2 * r + 1) ** 2
    ref_sh = [_pack(_shift_edge(ref_img, dy, dx), parity)
              for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    sr = functools.reduce(torch.add, ref_sh)
    srr = functools.reduce(torch.add, [x * x for x in ref_sh])
    r_mean = sr / area
    r_var = torch.clamp(srr / area - r_mean * r_mean, min=1e-8)
    return {"rays": _pack(rays, parity), "ref_sh": ref_sh, "r_mean": r_mean, "r_var": r_var}


def _draws(gen, draws, shape0, shape, n_half: int, dtype, device):
    """u0 of shape0, then (u_local, u_full) of `shape` for each of the
    n_half half-iterations: from `draws` = (u0, [(u_local, u_full), ...])
    when given, else drawn lazily from the generator `gen`."""
    if draws is not None:
        u0, halves = draws
        if len(halves) != n_half:
            raise ValueError(f"need {n_half} (u_local, u_full) draws, got {len(halves)}")
        yield torch.as_tensor(u0, dtype=dtype, device=device)
        for ul, uf in halves:
            yield (torch.as_tensor(ul, dtype=dtype, device=device),
                   torch.as_tensor(uf, dtype=dtype, device=device))
        return
    if gen is None:
        raise ValueError("pass a torch.Generator or the uniform draws")
    yield torch.rand(shape0, generator=gen, dtype=dtype, device=device)
    for _ in range(n_half):
        yield (torch.rand(shape, generator=gen, dtype=dtype, device=device),
               torch.rand(shape, generator=gen, dtype=dtype, device=device))


def split_generator(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """n independent generators seeded from draws of `gen` (the counterpart
    of jax.random.split(key, n))."""
    seeds = torch.randint(0, 2**62, (n,), generator=gen, device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(int(s)) for s in seeds]


# ---------------------------------------------------------------------------
# K3's plain version: rectified-frame candidate scoring


def pm_score_rect_plain(
    cands: torch.Tensor,  # (C, H, W) candidate disparity maps (>= 0)
    ref_rect: torch.Tensor,  # (H, W) rectified ref image
    nbr_rect: torch.Tensor,  # (H, W) rectified neighbour
    in_n: torch.Tensor,  # (H, W) bool neighbour validity
    r_mean: torch.Tensor,  # (H, W) ref window mean
    r_var: torch.Tensor,  # (H, W) ref window variance
    maxd: int,
    window_radius: int = 3,
    parity: int | None = None,
) -> torch.Tensor:
    """Costs (C, H, W) of C disparity candidate maps: the semantics of the
    JAX package's pm_score_rect (ops/pallas/pm_kernel.py), in plain torch.
    With `parity` 0 or 1 only the pixels with (y + x) % 2 == parity keep
    their cost and the others get 1 (K3 scores only those); None, the JAX
    package's contract, scores every pixel.

    Per pixel (y, x) and candidate d = di + frac (di = floor(d)): over the
    window dy, o in [-r, r] the neighbour sample is
        s_o = (1 - frac) * n[y', x + o - di] + frac * n[y', x + o - di - 1]
    (y' = y + dy clamped to [0, H-1]; n is the neighbour with invalid pixels
    zeroed, reading 0 outside [0, W)), scored by ZNCC against the ref taps
    ref[y', x + o] (0 outside [0, W)) with the given window statistics:
    cost (1 - clip(zncc, -1, 1)) / 2, and 1 where either centre tap
    (x - di, x - di - 1) of the neighbour is invalid. The sums run dy outer,
    o inner, in the order of the TPU kernel and of K3, which is what makes
    K3 bit-equal to this function.

    Candidates are expected in [0, maxd] (the callers clip them); the JAX
    package sizes its padded layout by maxd. Reading the neighbour directly
    makes the result independent of maxd for every candidate, so maxd is
    checked and otherwise unused."""
    if maxd < 0:
        raise ValueError(f"maxd must be >= 0, got {maxd}")
    if parity not in (None, 0, 1):
        raise ValueError(f"parity must be None, 0 or 1, got {parity!r}")
    c, h, w = cands.shape
    r = window_radius
    dev, f32 = cands.device, torch.float32
    # a tensor on the device: on the card torch divides by a CPU scalar as a
    # multiply by its reciprocal, and K3 divides
    area = torch.tensor(float((2 * r + 1) ** 2), dtype=f32, device=dev)
    cands = cands.to(f32)
    di = torch.floor(cands)
    frac = cands - di
    omf = 1 - frac
    # column index into a buffer with one zero column on each side: a tap
    # outside [0, W) clamps onto a zero column, for any candidate
    wp = w + 2
    base = 1 + torch.arange(w, device=dev) - di.long()  # (C, H, W): column of offset 0

    def padded(img):
        return torch.nn.functional.pad(img.to(f32), (1, 1))

    def taps(buf, yy, off):
        idx = (base + off).clamp_(0, wp - 1)
        return torch.gather(buf[yy].expand(c, h, wp), 2, idx)

    nbr_p = padded(torch.where(in_n, nbr_rect.to(f32), torch.zeros((), dtype=f32, device=dev)))
    ref_p = torch.nn.functional.pad(ref_rect.to(f32), (r, r))
    rows = torch.arange(h, device=dev)
    sn = torch.zeros((c, h, w), dtype=f32, device=dev)
    snn = torch.zeros_like(sn)
    srn = torch.zeros_like(sn)
    for dy in range(-r, r + 1):
        yy = (rows + dy).clamp(0, h - 1)
        t = [taps(nbr_p, yy, k - r - 1) for k in range(2 * r + 2)]  # offsets -r-1 .. r
        ref_row = ref_p[yy]
        for o in range(2 * r + 1):
            s_o = omf * t[o + 1] + frac * t[o]
            sn = sn + s_o
            snn = snn + s_o * s_o
            srn = srn + ref_row[:, o:o + w] * s_o
    msk_p = padded(in_n)
    inside = (taps(msk_p, rows, 0) * taps(msk_p, rows, -1)) > 0.5
    n_mean = sn / area
    n_var = torch.clamp(snn / area - n_mean * n_mean, min=1e-8)
    cov = srn / area - r_mean.to(f32) * n_mean
    zncc = cov / torch.sqrt(torch.clamp(r_var.to(f32), min=1e-8) * n_var)
    cost = (1.0 - torch.clamp(zncc, -1.0, 1.0)) * 0.5
    one = torch.ones((), dtype=f32, device=dev)
    cost = torch.where(inside, cost, one)
    if parity is None:
        return cost
    active = (rows[:, None] + torch.arange(w, device=dev)) % 2 == parity
    return torch.where(active, cost, one)


# ---------------------------------------------------------------------------
# classic PatchMatch in the rectified frame


def _pm_rect_pair(
    ref_img, nbr_img, pose_r, pose_n, intr, z_min, z_max, gen=None, draws=None,
    iterations: int = 8, window_radius: int = 3, max_cost: float = 0.4, max_disp: int = 256,
):
    """Classic PatchMatch disparity for ONE rectified pair; returns
    (depth, cost, valid) in the REFERENCE frame. Random numbers come from
    `gen` or from `draws` (module docstring); all are (H, W)."""
    from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import window_stats
    from sfm_mvs_pipeline_tpu_torch.mvs.rectified import rect_back_to_ref, rect_frame
    from sfm_mvs_pipeline_tpu_torch.ops.kernels.pm_kernel import pm_score_rect

    h, w = ref_img.shape
    dt, dev = ref_img.dtype, ref_img.device
    r = window_radius
    fr = rect_frame(ref_img, nbr_img, pose_r, pose_n, intr)
    ref_rect, in_r = fr["ref_rect"], fr["in_r"]
    fb = intr[0].to(dt) * fr["b"]
    d_lo = fb / torch.as_tensor(z_max, dtype=dt, device=dev)
    d_hi = torch.clamp(fb / torch.as_tensor(z_min, dtype=dt, device=dev), max=float(max_disp))
    span = torch.clamp(d_hi - d_lo, min=1e-3)
    r_mean, r_var = window_stats(ref_rect, r)
    one = torch.ones((), dtype=dt, device=dev)

    def score(cands, parity=None):
        c = pm_score_rect(cands, ref_rect, fr["nbr_rect"], fr["in_n"], r_mean, r_var,
                          maxd=max_disp, window_radius=r, parity=parity)
        # ref-side rectified-validity gate (the sweep engine's `inside & in_r`)
        return torch.where(in_r[None], c, one)

    rnd = _draws(gen, draws, (h, w), (h, w), 2 * iterations, dt, dev)
    d = d_lo + span * next(rnd)
    cost = score(d[None])[0]
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    par = (ys + xs) % 2
    for it in range(iterations):
        scale = span * (0.5 ** (it + 1.0))
        for parity in (0, 1):
            u_local, u_full = next(rnd)
            props = [_shift_edge(d, -1, 0), _shift_edge(d, 1, 0),
                     _shift_edge(d, 0, -1), _shift_edge(d, 0, 1)]
            rand_local = d + scale * (2.0 * u_local - 1.0)
            rand_full = d_lo + span * u_full
            cands = torch.clamp(torch.stack(props + [rand_local, rand_full]), d_lo, d_hi)
            # only this parity's pixels can change: score just those
            ccosts = score(cands, parity)  # (6, H, W), 1 at the other parity
            ci = torch.argmin(ccosts, dim=0, keepdim=True)
            cbest = torch.gather(ccosts, 0, ci)[0]
            cd = torch.gather(cands, 0, ci)[0]
            better = (cbest < cost) & (par == parity)
            d = torch.where(better, cd, d)
            cost = torch.where(better, cbest, cost)

    iz_rect = d / torch.clamp(fb, min=1e-9)
    val_rect = (cost <= max_cost) & fr["ok_geom"]
    return rect_back_to_ref(iz_rect, cost, val_rect, fr["H_ref"], fr["Kinv"], fr["R_r"],
                            fr["R_R"], fr["ok_geom"], h, w)


def patchmatch_rect_depth(
    ref_img: torch.Tensor,  # (H, W)
    nbr_imgs: torch.Tensor,  # (N, H, W)
    pose_r: torch.Tensor,
    poses_n: torch.Tensor,  # (N, 6)
    intr: torch.Tensor,
    z_min: float,
    z_max: float,
    gen: torch.Generator | None = None,
    iterations: int = 8,
    window_radius: int = 3,
    max_cost: float = 0.4,
    max_disp: int = 256,
    nbr_valid=None,  # (N,) bool, host array or list
    draws=None,  # one (u0, halves) per neighbour, in place of gen
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-neighbour classic PatchMatch (rectified frame, K3-scored):
    per-pair disparity PatchMatch + cross-neighbour consensus; the contract
    of patchmatch_depth / rectified_depth.

    Each neighbour draws from its own generator, split from `gen` for every
    slot (padded ones included, as the JAX package splits its key per
    neighbour). Padded slots (nbr_valid False) are not computed: the JAX
    package masks them to cost 1 and invalid, which leaves them no influence
    on the consensus; here they are filled with those values."""
    from sfm_mvs_pipeline_tpu_torch.mvs.rectified import consensus_fuse

    n = nbr_imgs.shape[0]
    ok = [True] * n if nbr_valid is None else [bool(x) for x in np.asarray(nbr_valid)]
    gens = split_generator(gen, n) if draws is None else [None] * n
    h, w = ref_img.shape
    depths, costs, valids = [], [], []
    for j in range(n):
        if not ok[j]:
            depths.append(torch.zeros((h, w), dtype=ref_img.dtype, device=ref_img.device))
            costs.append(torch.ones_like(depths[-1]))
            valids.append(torch.zeros((h, w), dtype=torch.bool, device=ref_img.device))
            continue
        with stage("patchmatch"):
            d, c, v = _pm_rect_pair(
                ref_img, nbr_imgs[j], pose_r, poses_n[j], intr, z_min, z_max, gen=gens[j],
                draws=None if draws is None else draws[j], iterations=iterations,
                window_radius=window_radius, max_cost=max_cost, max_disp=max_disp)
        depths.append(d)
        costs.append(c)
        valids.append(v)
    with stage("consensus"):
        return consensus_fuse(torch.stack(depths), torch.stack(costs), torch.stack(valids),
                              max_cost=max_cost, min_support=2)


# ---------------------------------------------------------------------------
# warp-based, parity-packed PatchMatch


def _cost_packed(
    inv_act: torch.Tensor,  # (H, W2) candidate inverse depth at active pixels
    consts: dict,
    nbr_imgs: torch.Tensor,  # (N, Hp, Wp), padded to an even width
    rels: torch.Tensor,  # (N, 6)
    K: torch.Tensor,
    nbr_ok: list[bool],  # False = padded slot
    window_radius: int,
    real_hw: tuple[int, int],
) -> torch.Tensor:
    """Photometric cost (H, W2) of one packed inverse-depth hypothesis:
    mean over the best half of the valid neighbours of (1 - ZNCC)/2;
    out-of-view samples cost 1. The (2r+2)^2 unique integer taps per
    neighbour are gathered once and shared by the (2r+1)^2 bilinear window
    samples (the JAX package's memoised form)."""
    r = window_radius
    area = (2 * r + 1) ** 2
    h_real, w_real = real_hw
    hp, wp = nbr_imgs.shape[-2:]
    depth = 1.0 / torch.clamp(inv_act, min=1e-9)
    X = consts["rays"] * depth[None]  # (3, H, W2) ref-frame points
    one = torch.ones((), dtype=inv_act.dtype, device=inv_act.device)

    def per_neighbor(nbr_img, rel):
        R = aa_to_rotmat(rel[:3])
        t = rel[3:]
        Xn = torch.einsum("ij,jhw->ihw", R, X) + t[:, None, None]
        p = torch.einsum("ij,jhw->ihw", K, Xn)
        z = torch.where(p[2].abs() < 1e-9, torch.full_like(p[2], 1e-9), p[2])
        xq = p[0] / z
        yq = p[1] / z
        inside = ((xq >= 0) & (xq <= w_real - 1.001) & (yq >= 0) & (yq <= h_real - 1.001)
                  & (p[2] > 1e-6))
        x0 = torch.floor(xq)
        y0 = torch.floor(yq)
        fx = xq - x0
        fy = yq - y0
        # non-finite coordinates are outside; clamp before the integer cast
        x0i = torch.nan_to_num(x0, nan=0.0).clamp(-wp - r - 2, 2 * wp + r + 2).long()
        y0i = torch.nan_to_num(y0, nan=0.0).clamp(-hp - r - 2, 2 * hp + r + 2).long()
        w00 = (1 - fx) * (1 - fy)
        w01 = fx * (1 - fy)
        w10 = (1 - fx) * fy
        w11 = fx * fy
        flat = nbr_img.reshape(-1)
        G = {}
        for dy in range(-r, r + 2):
            yy = (y0i + dy).clamp(0, hp - 1) * wp
            for dx in range(-r, r + 2):
                G[(dy, dx)] = flat[yy + (x0i + dx).clamp(0, wp - 1)]
        sn = torch.zeros_like(inv_act)
        snn = torch.zeros_like(inv_act)
        srn = torch.zeros_like(inv_act)
        o = 0
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                s_o = (w00 * G[(dy, dx)] + w01 * G[(dy, dx + 1)]
                       + w10 * G[(dy + 1, dx)] + w11 * G[(dy + 1, dx + 1)])
                sn = sn + s_o
                snn = snn + s_o * s_o
                srn = srn + consts["ref_sh"][o] * s_o
                o += 1
        n_mean = sn / area
        n_var = torch.clamp(snn / area - n_mean * n_mean, min=1e-8)
        cov = srn / area - consts["r_mean"] * n_mean
        zncc = cov / torch.sqrt(consts["r_var"] * n_var)
        cost = (1.0 - torch.clamp(zncc, -1.0, 1.0)) * 0.5
        return torch.where(inside, cost, one)

    costs = torch.stack([per_neighbor(nbr_imgs[j], rels[j]) if ok else torch.ones_like(inv_act)
                         for j, ok in enumerate(nbr_ok)])  # (N, H, W2)
    n = costs.shape[0]
    srt = torch.sort(costs, dim=0).values
    n_valid = torch.tensor(float(sum(nbr_ok)), dtype=costs.dtype, device=costs.device)
    k_dyn = torch.clamp(torch.ceil(n_valid / 2.0), min=1.0)
    take = (torch.arange(n, dtype=costs.dtype, device=costs.device) < k_dyn).to(costs.dtype)
    return torch.einsum("nhw,n->hw", srt, take) / k_dyn


def patchmatch_depth(
    ref_img: torch.Tensor,  # (H, W) grayscale f32
    nbr_imgs: torch.Tensor,  # (N, H, W)
    pose_r: torch.Tensor,  # (6,)
    poses_n: torch.Tensor,  # (N, 6)
    intr: torch.Tensor,  # (7,) intrinsics scaled to this resolution
    z_min: float,
    z_max: float,
    gen: torch.Generator | None = None,
    init_depth: torch.Tensor | None = None,  # (H, W) seed
    init_valid: torch.Tensor | None = None,  # (H, W) bool for the seed
    iterations: int = 8,
    window_radius: int = 3,
    max_cost: float = 0.4,
    nbr_valid=None,  # (N,) bool, host array or list — False = padded slot
    draws=None,  # (u0 (H, Wp), [(u_local, u_full) (H, Wp/2), ...]) in place of gen
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PatchMatch depth for one reference view, warp-based and parity-packed.

    Returns (depth (H, W), cost (H, W), valid (H, W)), the contract of
    plane_sweep.wta_depth. An odd width is padded by one edge column (Wp =
    W + 1), which every output drops."""
    h, w = ref_img.shape
    dt, dev = ref_img.dtype, ref_img.device
    wp = w + (w % 2)
    if wp != w:
        def pad(x):
            return torch.cat([x, x[..., -1:]], dim=-1)

        ref_img, nbr_imgs = pad(ref_img), pad(nbr_imgs)
        init_depth = None if init_depth is None else pad(init_depth)
        init_valid = None if init_valid is None else pad(init_valid)
    K = intrinsics_to_K(intr).to(dt)
    rays = _ref_rays(h, wp, K, dt)
    rels = relative_pose(pose_r[None].expand(poses_n.shape[0], 6), poses_n)
    nbr_ok = ([True] * nbr_imgs.shape[0] if nbr_valid is None
              else [bool(x) for x in np.asarray(nbr_valid)])

    inv_lo = 1.0 / torch.as_tensor(z_max, dtype=dt, device=dev)
    inv_hi = 1.0 / torch.as_tensor(z_min, dtype=dt, device=dev)
    span = inv_hi - inv_lo
    r = window_radius
    consts = [_parity_consts(ref_img, rays, p, r) for p in (0, 1)]
    cost_of = [functools.partial(_cost_packed, consts=consts[p], nbr_imgs=nbr_imgs, rels=rels,
                                 K=K, nbr_ok=nbr_ok, window_radius=r, real_hw=(h, w))
               for p in (0, 1)]

    rnd = _draws(gen, draws, (h, wp), (h, wp // 2), 2 * iterations, dt, dev)
    inv = inv_lo + span * next(rnd)
    if init_depth is not None:
        seed_inv = 1.0 / torch.clamp(init_depth.to(dt), min=1e-9)
        seed_ok = torch.isfinite(seed_inv) & (seed_inv >= inv_lo) & (seed_inv <= inv_hi)
        if init_valid is not None:
            seed_ok = seed_ok & init_valid
        inv = torch.where(seed_ok, seed_inv, inv)
    cost = torch.zeros((h, wp), dtype=dt, device=dev)
    for p in (0, 1):
        cost = _unpack_update(cost, cost_of[p](_pack(inv, p)), p)

    for it in range(iterations):
        scale = span * (0.5 ** (it + 1.0))
        for parity in (0, 1):
            u_local, u_full = next(rnd)
            inv_act = _pack(inv, parity)
            cost_act = _pack(cost, parity)
            # propagation: the 4 neighbours' values (edge-replicated shifts)
            props = [_pack(_shift_edge(inv, -1, 0), parity), _pack(_shift_edge(inv, 1, 0), parity),
                     _pack(_shift_edge(inv, 0, -1), parity), _pack(_shift_edge(inv, 0, 1), parity)]
            # random search: geometric shrink of the window + full range
            rand_local = inv_act + scale * (2.0 * u_local - 1.0)
            rand_full = inv_lo + span * u_full
            cands = torch.clamp(torch.stack(props + [rand_local, rand_full]), inv_lo, inv_hi)
            ccosts = torch.stack([cost_of[parity](c) for c in cands])  # (C, H, W2)
            ci = torch.argmin(ccosts, dim=0, keepdim=True)
            cbest = torch.gather(ccosts, 0, ci)[0]
            cinv = torch.gather(cands, 0, ci)[0]
            better = cbest < cost_act
            inv = _unpack_update(inv, torch.where(better, cinv, inv_act), parity)
            cost = _unpack_update(cost, torch.where(better, cbest, cost_act), parity)

    depth = 1.0 / torch.clamp(inv, min=1e-9)
    valid = cost <= max_cost
    return depth[:, :w], cost[:, :w], valid[:, :w]
