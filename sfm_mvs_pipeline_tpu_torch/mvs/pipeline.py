"""Dense MVS orchestration: undistort -> ladder -> depth maps -> fuse -> mesh.

Port of sfm_mvs_pipeline_tpu/mvs/pipeline.py, after MVS::densifyScene /
MVS::meshScene (ref: src/photogrammetrie/mvs/MVS.cpp:100-181) and the
exporter's undistorted-image handoff (ref: OpenMvsUtils.cpp:136-152):
  * resolution ladder: max 3200 (ref: MVS.h:60-61), never upsampled
  * 5 neighbor views (ref: MVS.h:58)
  * 3-view fusion inliers (ref: MVS.h:62)
  * depth engines `rect` (default), `sweep` and `patchmatch`, SGM with
    --sgm (ref: MVS.cpp:112-120)
  * meshing + cleanup + optional refine/texture (ref: MVS.cpp:130-181)

Every view's depth map comes from one function, depth_map_view, and
depth_maps_by_view runs it over the views: on one device for every view,
and over more shards (the cards of this process's mesh, each in a thread
of its own, or torchrun's ranks, one device each) for each shard's block
of the views, gathered in view order, so the depth maps do not depend on
the shard count. Fusion, meshing and writing run once: in a
mesh on its first card; under torchrun on rank 0 alone, as the other
ranks return after the gather (no collective follows it).
`patchmatch` runs classic PatchMatch in the rectified frame of each pair
(kernel K3) on every device, where the JAX package does so on its TPU's
one-device path only; views whose every
neighbour fails the rectification geometry gate take the warp-based
PatchMatch, seeded from the rectified sweep. As in the JAX package,
`patchmatch` with --sgm runs the sweep engine with SGM. Each view's rect
engine takes its own derive_max_disp, where the JAX package's sharded
branch takes the largest over the views.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import count, stage


@dataclasses.dataclass
class MVSConfig:
    max_resolution: int = 3200
    n_neighbors: int = 5
    n_planes: int = 96
    window_radius: int = 3
    max_cost: float = 0.35
    min_fusion_views: int = 3
    fusion_tolerance: float = 0.01
    use_sgm: bool = False
    sgm_p1: float = 0.03
    sgm_p2: float = 0.3
    # depth-map method:
    #   "rect"       rectified pairwise disparity sweep (mvs/rectified.py)
    #   "sweep"      joint plane-sweep cost volume (mvs/plane_sweep.py)
    #   "patchmatch" checkerboard PatchMatch (mvs/patchmatch.py), the
    #                reference's openMVS default (the sweep with SGM when
    #                use_sgm is set)
    method: str = "rect"
    pm_iterations: int = 8
    # the warp-based PatchMatch (geometry-degenerate views) starts from the
    # rectified sweep's depth and runs pm_iterations//4 (at least 2)
    # iterations; False gives it the classic random init and pm_iterations
    pm_seed_rect: bool = True
    mesh: bool = False
    decimate: bool = True
    refine_mesh: bool = False
    texture: bool = False
    keep_artifacts: bool = False


def _undistort_image(img: np.ndarray, intr: np.ndarray, device: torch.device) -> np.ndarray:
    """Resample an image so straight lines are straight under pinhole K.

    For each undistorted target pixel: normalized -> distort -> source pixel
    (the map cv2.initUndistortRectifyMap builds; the reference exports
    undistorted PNGs the same way, OpenMvsUtils.cpp:136-150), sampled
    bilinearly with the dense engines' clamped taps, on `device`. Returns
    float32."""
    from sfm_mvs_pipeline_tpu_torch.models.cameras import (
        distort_normalized,
        normalized_to_pixels,
        pixels_to_normalized,
    )
    from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import _bilinear_hw, pixel_grid

    dev = device
    h, w = img.shape[:2]
    intr_d = torch.as_tensor(np.asarray(intr, np.float32), device=dev)
    uv = pixel_grid(h, w, torch.float32, dev)[:2].T  # (H*W, 2)
    xy = pixels_to_normalized(intr_d, uv)  # undistorted normalized (target)
    src = normalized_to_pixels(intr_d, distort_normalized(intr_d, xy)).reshape(h, w, 2)
    img_d = torch.as_tensor(np.ascontiguousarray(img), device=dev).to(torch.float32)
    if img.ndim == 2:
        return _bilinear_hw(img_d, src[..., 0], src[..., 1])[0].cpu().numpy()
    chans = [_bilinear_hw(img_d[..., c].contiguous(), src[..., 0], src[..., 1])[0]
             for c in range(img.shape[2])]
    return torch.stack(chans, dim=-1).cpu().numpy()


def run_mvs(scene, out_dir: str, cfg: MVSConfig | None = None, log=lambda *a: None,
            device: torch.device | str | None = None, devices=None) -> dict:
    """Densify (and optionally mesh) a reconstructed scene on the mesh
    `devices`, or `device` (give one: a Mesh or a resolve_devices spec;
    default every visible card; raises without one; under torchrun the
    rank's card): the depth maps view-sharded over its cards (or the
    ranks), everything else on its first.
    Writes pointcloud_dense.ply (+ mesh_dense.ply) into out_dir. Returns
    results: the depth maps and valids, and on rank 0 (every run outside a
    process group) the dense cloud and mesh."""
    import cv2

    from sfm_mvs_pipeline_tpu_torch.mvs.fusion import fuse_depth_maps
    from sfm_mvs_pipeline_tpu_torch.mvs.neighbors import (
        depth_range,
        fixed_neighbor_table,
        select_neighbors,
    )
    from sfm_mvs_pipeline_tpu_torch.mvs.rectified import rect_geometry_ok
    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards, check_agree
    from sfm_mvs_pipeline_tpu_torch.utils.images import load_rgb
    from sfm_mvs_pipeline_tpu_torch.utils.ply import write_ply_points

    cfg = cfg or MVSConfig()
    if cfg.method not in ("rect", "sweep", "patchmatch"):
        raise ValueError(f"unknown dense method {cfg.method!r}")
    shards = Shards.of_entry(device, devices)
    dev = shards.first
    rec = [int(s) for s in np.nonzero(scene.recovered)[0]]
    if len(rec) < 2:
        log("not enough recovered views for densification")
        return {}
    w0, h0 = scene.image_size
    intr0 = scene.intrinsics[0]

    # resolution ladder (ref: resetImageResoloution semantics); never
    # upsample beyond native
    scale = 1.0
    if max(w0, h0) > cfg.max_resolution:
        scale = cfg.max_resolution / max(w0, h0)
    w = int(round(w0 * scale))
    h = int(round(h0 * scale))
    intr = intr0.copy()
    intr[:3] *= scale
    intr_pinhole = intr.copy()
    intr_pinhole[3:] = 0.0  # images get undistorted below

    method = "SGM" if cfg.use_sgm else {
        "patchmatch": "PatchMatch", "sweep": "plane-sweep"}.get(cfg.method, "rectified-sweep")
    log(f"densifying {len(rec)} views at {w}x{h} ({method}, {cfg.n_planes} planes)")

    with stage("load + undistort"):
        grays, rgbs = [], []
        for s in rec:
            rgb = load_rgb(scene.image_paths[s], (w0, h0))
            if scale != 1.0:
                rgb = cv2.resize(rgb, (w, h), interpolation=cv2.INTER_AREA)
            rgb_u = _undistort_image(rgb, intr, dev)
            gray = cv2.cvtColor(rgb_u.astype(np.uint8), cv2.COLOR_RGB2GRAY)
            grays.append(gray.astype(np.float32) / 255.0)
            rgbs.append(rgb_u.astype(np.uint8))
        grays = np.stack(grays)
        rgbs = np.stack(rgbs)
        grays_d = torch.as_tensor(grays, device=dev)

    neighbors = select_neighbors(scene, cfg.n_neighbors)
    idx_of = {s: i for i, s in enumerate(rec)}

    poses = scene.poses[rec].astype(np.float32)
    poses_d = torch.as_tensor(poses, device=dev)
    intr_d = torch.as_tensor(intr_pinhole, dtype=torch.float32, device=dev)

    # Rect-engine degeneracy precheck: views whose EVERY neighbor fails the
    # rectification-geometry gate (near-forward motion) would produce empty
    # depth maps, so depth_map_view routes them through the plane sweep;
    # logged here with the partially-masked views.
    if cfg.method == "rect":
        for i, s in enumerate(rec):
            nbrs_i = [idx_of[n] for n in neighbors.get(s, []) if n in idx_of]
            if not nbrs_i:
                continue
            geom_ok = rect_geometry_ok(poses[i], poses[nbrs_i])
            n_bad = int((~geom_ok).sum())
            if not geom_ok.any():
                log(
                    f"view {s}: all {len(nbrs_i)} neighbors fail the "
                    "rectification geometry gate (near-forward baseline) — "
                    "falling back to plane sweep for this view"
                )
            elif n_bad:
                log(f"view {s}: {n_bad}/{len(nbrs_i)} neighbors masked by "
                    "the rectification geometry gate")

    def one_view(i, grays_d, poses_d, intr_d):
        s = rec[i]
        nbrs = [idx_of[n] for n in neighbors.get(s, []) if n in idx_of]
        if not nbrs:
            log(f"view {s}: no neighbors, skipped")
            return None
        z_lo, z_hi = depth_range(scene, s)
        depth, valid, tag = depth_map_view(cfg, i, nbrs, grays_d, poses, poses_d, intr_d,
                                           float(intr_pinhole[0]), z_lo, z_hi, w)
        log(f"view {s}: depth range [{z_lo:.2f}, {z_hi:.2f}], "
            f"{int(valid.sum())}/{h*w} valid px{tag}")
        return depth, valid

    if shards.count > 1:
        log(f"view-sharded depth maps over {shards.count} {shards.kind}")
        check_agree("run_mvs", grays, poses, intr_pinhole,
                    *fixed_neighbor_table(neighbors, rec, cfg.n_neighbors),
                    np.array([depth_range(scene, s) for s in rec]))
    depth_maps, valids = depth_maps_by_view(len(rec), one_view, h, w, shards,
                                            (grays_d, poses_d, intr_d))
    results = {"depth_maps": depth_maps, "valids": valids}
    if shards.held[0] != 0:  # fusion, mesh and texture make only what rank 0 writes
        return results
    if cfg.keep_artifacts:
        for i, s in enumerate(rec):
            np.save(os.path.join(out_dir, f"depth_{s:04d}.npy"), depth_maps[i])

    with stage("fusion"):
        fused = fuse_depth_maps(
            depth_maps, valids, poses, intr_pinhole.astype(np.float32), rgbs,
            # can't demand more consistent views than exist (tiny scenes)
            min_views=min(cfg.min_fusion_views, len(rec)),
            rel_tolerance=cfg.fusion_tolerance,
            log=log,
            device=dev,
        )
        log(f"fused dense cloud: {len(fused['points'])} points")
        with stage("fusion write"):
            write_ply_points(os.path.join(out_dir, "pointcloud_dense.ply"),
                             fused["points"], fused["colors"], fused["normals"])

    results["dense"] = fused
    if cfg.mesh:
        results["mesh"] = _mesh(cfg, out_dir, depth_maps, valids, poses,
                                intr_pinhole.astype(np.float32), rgbs, grays, log, results, dev)
    return results


def depth_map_view(cfg, i, nbrs, grays_d, poses, poses_d, intr_d, focal, z_lo, z_hi, w,
                   planes=None, max_disp=None):
    """Depth map of view `i` (its index in the recovered views) from its
    neighbours `nbrs` (indices into the same views), by cfg.method: the
    rect engine (--sgm: SGM on each pair's volume, kernel K2a or K2b), the
    plane sweep for a rect view whose every neighbour fails the
    rectification geometry gate and for `sweep` (--sgm: the sweep volume
    aggregated), or PatchMatch (_patchmatch_view; with --sgm the sweep).
    `planes` is the sweep's ladder (default: make_depth_planes over [z_lo,
    z_hi] with cfg.n_planes); `max_disp` the rect engine's disparity bound
    (default: this view's derive_max_disp). Returns (depth, valid, log tag)
    on the device. run_mvs (through depth_maps_by_view) and the JAX-signature
    entry parallel/mvs.py::compute_depth_maps_sharded both call this."""
    from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import (
        make_depth_planes,
        sweep_cost_volume,
        wta_depth,
    )
    from sfm_mvs_pipeline_tpu_torch.mvs.rectified import (
        derive_max_disp,
        rect_geometry_ok,
        rectified_depth,
    )
    from sfm_mvs_pipeline_tpu_torch.mvs.sgm import sgm_aggregate

    if cfg.method == "patchmatch" and not cfg.use_sgm:
        depth, _, valid, tag = _patchmatch_view(cfg, i, nbrs, grays_d, poses, poses_d, intr_d,
                                                focal, z_lo, z_hi, w)
        return depth, valid, tag
    if cfg.method == "rect" and rect_geometry_ok(poses[i], poses[nbrs]).any():
        # --sgm composes with the rectified engine: 4-path aggregation
        # on the per-pair rectified disparity volume
        cap = cfg.n_neighbors
        nb = (nbrs + [nbrs[0]] * cap)[:cap]
        nb_ok = np.zeros(cap, bool)
        nb_ok[: min(len(nbrs), cap)] = True
        if max_disp is None:
            max_disp = derive_max_disp(poses[i], poses[nb], focal, float(z_lo), w)
        depth, _, valid = rectified_depth(
            grays_d[i], grays_d[nb], poses_d[i], poses_d[nb], intr_d, z_lo, z_hi,
            n_levels=cfg.n_planes, window_radius=cfg.window_radius,
            max_cost=cfg.max_cost, max_disp=max_disp, nbr_valid=nb_ok,
            use_sgm=cfg.use_sgm, sgm_p1=cfg.sgm_p1, sgm_p2=cfg.sgm_p2,
        )
        return depth, valid, ""
    if planes is None:
        planes = make_depth_planes(z_lo, z_hi, cfg.n_planes).astype(np.float32)
    planes = torch.as_tensor(planes, device=grays_d.device)
    with stage("sweep"):
        cv = sweep_cost_volume(grays_d[i], grays_d[nbrs], poses_d[i], poses_d[nbrs],
                               intr_d, planes, window_radius=cfg.window_radius)
    if cfg.use_sgm:
        with stage("sgm"):
            cv = sgm_aggregate(cv, cfg.sgm_p1, cfg.sgm_p2)
    with stage("sweep"):
        depth, _, valid = wta_depth(cv, planes, cfg.max_cost)
    return depth, valid, ""


def depth_maps_by_view(n_views: int, one_view, h: int, w: int, shards,
                       inputs: tuple = ()) -> tuple[np.ndarray, np.ndarray]:
    """(depth (V, H, W) f32, valid (V, H, W) bool) of every view, from
    one_view(i, *inputs) -> (depth, valid) tensors, or None (no depth:
    zeros, invalid). Each of the `shards` (parallel/distributed.py::Shards)
    computes its contiguous block of the views (a shard past the last view
    computes none) with `inputs` replicated to its device; the blocks are
    gathered in shard order, which is view order (valid as uint8 on a
    process group's wire). One shard computes every view."""
    from sfm_mvs_pipeline_tpu_torch.parallel.mesh import block

    def one(sh, *rep):
        lo, hi = block(n_views, sh.index, sh.count)
        depth = torch.zeros((hi - lo, h, w), dtype=torch.float32, device=sh.device)
        valid = torch.zeros((hi - lo, h, w), dtype=torch.bool, device=sh.device)
        for i in range(lo, min(hi, n_views)):
            res = one_view(i, *rep)
            if res is not None:
                depth[i - lo], valid[i - lo] = res
        with stage("depth-map gather"):
            return sh.all_gather_cat(depth)[:n_views], sh.all_gather_cat(valid)[:n_views]

    depth, valid = shards.run(one, *(shards.replicated(x) for x in inputs))[0]
    return depth.cpu().numpy(), valid.cpu().numpy()


def _patchmatch_view(cfg, i, nbrs, grays_d, poses, poses_d, intr_d, focal, z_lo, z_hi, w):
    """PatchMatch depth of view `i` (its index in the recovered views):
    rectified PatchMatch (K3) when a neighbour passes the rectification
    geometry gate, else the warp-based PatchMatch seeded from the rectified
    sweep. The view's generator is seeded with i, as the JAX package folds
    i into PRNGKey(0). The stage timer counts the view in "pm views", and
    in "pm rect views" where it takes the rectified route. Returns (depth,
    cost, valid, log tag)."""
    from sfm_mvs_pipeline_tpu_torch.mvs.patchmatch import patchmatch_depth, patchmatch_rect_depth
    from sfm_mvs_pipeline_tpu_torch.mvs.rectified import (
        derive_max_disp,
        rect_geometry_ok,
        rectified_depth,
    )

    # fixed neighbour capacity, as in the JAX package
    cap = cfg.n_neighbors
    nb = (nbrs + [nbrs[0]] * cap)[:cap]
    nb_ok = np.zeros(cap, bool)
    nb_ok[: min(len(nbrs), cap)] = True
    geo_ok = rect_geometry_ok(poses[i], poses[nb]) & nb_ok
    md = derive_max_disp(poses[i], poses[nb], focal, float(z_lo), w)
    gen = torch.Generator(device=grays_d.device).manual_seed(i)
    count("pm views")
    if geo_ok.any():
        count("pm rect views")
        depth, cost, valid = patchmatch_rect_depth(
            grays_d[i], grays_d[nb], poses_d[i], poses_d[nb], intr_d, z_lo, z_hi, gen,
            iterations=cfg.pm_iterations, window_radius=cfg.window_radius,
            max_cost=cfg.max_cost, max_disp=md, nbr_valid=geo_ok)
        return depth, cost, valid, " (rect-PM)"
    seed_d = seed_v = None
    iters = cfg.pm_iterations
    if cfg.pm_seed_rect:
        # the host gate is stricter (0.31) than the engine's (0.3), so a pair
        # may still seed; a pair that fails the engine's gate seeds nothing
        # and is skipped (its rectification is singular when the baseline
        # lies on the optical axis, and torch refuses to invert it)
        seed_ok = rect_geometry_ok(poses[i], poses[nb], min_sin=0.3) & nb_ok
        if seed_ok.any():
            seed_d, _, seed_v = rectified_depth(
                grays_d[i], grays_d[nb], poses_d[i], poses_d[nb], intr_d, z_lo, z_hi,
                n_levels=cfg.n_planes, window_radius=cfg.window_radius, max_cost=cfg.max_cost,
                max_disp=md, nbr_valid=seed_ok)
        iters = max(2, cfg.pm_iterations // 4)
    with stage("patchmatch"):
        depth, cost, valid = patchmatch_depth(
            grays_d[i], grays_d[nb], poses_d[i], poses_d[nb], intr_d, z_lo, z_hi, gen,
            init_depth=seed_d, init_valid=seed_v, iterations=iters,
            window_radius=cfg.window_radius, max_cost=cfg.max_cost, nbr_valid=nb_ok)
    return depth, cost, valid, ""


def _mesh(cfg, out_dir, depth_maps, valids, poses, intr, rgbs, grays, log, results, dev):
    """Mesh the depth maps, optionally refine and texture; writes
    mesh_dense.ply (textured when cfg.texture, with its atlas PNG)."""
    from sfm_mvs_pipeline_tpu_torch.mvs.mesh import mesh_from_depth_maps
    from sfm_mvs_pipeline_tpu_torch.utils.ply import write_ply_mesh

    with stage("mesh"):
        mesh = mesh_from_depth_maps(depth_maps, valids, poses, intr, rgbs,
                                    decimate=cfg.decimate, log=log, device=dev)
    if cfg.refine_mesh and len(mesh["faces"]):
        # photometric refinement (openMVS RefineMesh stand-in, ref: MVS.cpp:157-172)
        from sfm_mvs_pipeline_tpu_torch.mvs.refine import refine_mesh_photometric

        with stage("refine"):
            mesh["vertices"] = refine_mesh_photometric(
                mesh["vertices"], mesh["faces"], poses, intr, grays, log=log, device=dev)
    path = os.path.join(out_dir, "mesh_dense.ply")
    if cfg.texture and len(mesh["faces"]):
        # texture atlas + textured PLY (openMVS TextureMesh, gated by
        # --colored like the reference — PhotogrammetrieCli.cpp:228)
        from sfm_mvs_pipeline_tpu_torch.mvs.texture import (
            build_texture_atlas,
            write_ply_mesh_textured,
        )

        with stage("texture"):
            with stage("texture atlas"):
                tex = build_texture_atlas(mesh["vertices"], mesh["faces"], poses, intr, rgbs,
                                          device=dev)
            with stage("texture write"):
                write_ply_mesh_textured(path, mesh["vertices"], mesh["faces"], tex["uv"],
                                        tex["atlas"], colors=mesh.get("colors"))
        log(f"textured mesh: atlas {tex['atlas'].shape[0]}x{tex['atlas'].shape[1]}")
        results["texture"] = tex
    else:
        with stage("mesh"):
            write_ply_mesh(path, mesh["vertices"], mesh["faces"], colors=mesh.get("colors"))
    log(f"mesh: {len(mesh['vertices'])} vertices, {len(mesh['faces'])} faces")
    return mesh
