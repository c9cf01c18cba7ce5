"""The end-to-end photogrammetry driver CLI.

Port of sfm_mvs_pipeline_tpu/cli/photogrammetrie.py, after
PhotogrammetrieCli (ref: src/cli/PhotogrammetrieCli.cpp:45-247): workdir
prep -> stats sampler -> SIFT or ORB -> scene -> SfM -> PLYs, stats,
artifacts and the scene.npz checkpoint -> dense MVS (--dense), or dense MVS
resumed from a checkpoint (-Presume=). The flags are the JAX package's.

Work runs on the cards (-Pdevice=cuda, the default: every visible card;
the run fails without one) or, when asked with -Pdevice=cpu, on the CPU,
where every kernel wrapper takes its plain PyTorch version. The cards
form one process's mesh (parallel/mesh.py), as the JAX package's
jax.devices() do: features, RANSAC, PnP, fusion, meshing, texturing and
the outputs run once on its first card, and matching and the depth maps
shard over its cards past the JAX package's gates; bundle adjustment runs
on the first card (sfm/incremental.py::_SHARDED_BA_MIN_OBS says why).
-Pdevice= also takes a list (cuda:0,cuda:1; cuda:0,cuda:0 for two shards
on one card; cpu,cpu,cpu,cpu).

Launched once per rank by torchrun, the CLI joins the process group first
(parallel/distributed.py) and each rank takes one card, LOCAL_RANK %
device_count (the card the ranks share where they outnumber the cards):
-Pdevice=cuda then means that card, a device named must be it (or cpu
under gloo), and a list raises: on one host, use the mesh. Every rank
runs the replicated stages (features, RANSAC, PnP, triangulation) on its
device; matching, bundle adjustment and the depth maps run sharded over
the ranks, one shard a rank, in rank order as the JAX package's process
mesh. Rank 0 alone wipes -Pout= and writes the outputs; after the
depth-map gather it alone fuses, meshes and textures
(mvs/pipeline.py::run_mvs).
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from sfm_mvs_pipeline_tpu_torch.parallel import distributed
from sfm_mvs_pipeline_tpu_torch.utils import logger as logging
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer
from sfm_mvs_pipeline_tpu_torch.utils.args import AppArgs

log = logging.AppLogger("PhotogrammetrieCli")


def print_usage() -> None:
    print(
        """photogrammetrie — sparse SfM + dense MVS (PyTorch + CUDA port)

  -Pimage=<dir|file>                 image directory (or repeated files)
  -Pout=<dir>                        working/output directory (default ./out)
  -Pcamera-model=simple|simple-radial|distortion   (default simple-radial)
  -Pdevice=cuda|cpu|<list>           where the work runs (default cuda:
                                     every visible card as one mesh, or
                                     fail; under torchrun the rank's one
                                     card; cpu runs the kernels' plain
                                     PyTorch versions; a list such as
                                     cuda:0,cuda:1 or cpu,cpu names the
                                     mesh's shards, outside torchrun)
  -Pfeature-detector=sift|orb        (default sift; orb = FAST-9 + Harris on
                                     an 8-level pyramid, rotated BRIEF)
  -Pfeature-limit=N                  max features per image (default 10000,
                                     max 262144; 0 = unlimited)
  -Pfeature-matcher=bf|flann         (default bf; flann runs the same exact
                                     brute-force kernel K1, as the JAX
                                     package does on its TPU)
  -Pmatch-precision=fast|exact       (default fast: kernel K1, fp32 FMAs;
                                     exact: kernel K1x, the bf16x3 split on
                                     the tensor cores, distances within
                                     4.6e-5 (|q|^2 + |t|^2); ORB
                                     descriptors always run K1, exactly)
  -Pfeature-sequence=N               video window / grid neighborhood size
  -Pfeature-gridlength=N             grid row length (enables grid pairing)
  -Pmatch-threshold=N                min matches per pair (default 20)
  -Pbaseline-homography-threshold=N  min matches for baseline pair (default 100)
  -Phomography-inlier-ratio-threshold=X  (default 0.4)
  -Ppose-inlier-ratio-threshold=X    (default 0.4)
  -Pransac-matching-threshold=X      <0: -abs px, >0: fraction of max dim (default -3)
  -Pransac-baseline-threshold=X      (default -1)
  -Pransac-pose-threshold=X          (default -8)
  -Preprojection-error-threshold=X   (default 10)
  -Ppointcloud-point-merge-distance=X    (default 0.01)
  -Ppointcloud-feature-merge-distance=X  (default 20)
  -Pomp-feature-threads=N            (accepted for compat; batching replaces it)
  -Presume=<scene.npz>               skip SfM, resume from a scene checkpoint
  -Pprofile=<dir>                    capture a torch.profiler trace (CPU and
                                     CUDA activity) of the run as a Chrome
                                     trace in <dir>
  --distinct-matches                 drop ambiguous (shared-target) matches
  --colored                          colorize the sparse cloud (+ texture the
                                     mesh, like the reference's TextureMesh)
  --dense                            run dense MVS
  --sgm                              SGM aggregation of the depth cost volumes
  -Pdense-method=rect|sweep|patchmatch  depth-map algorithm (default rect =
                                     rectified disparity sweep; sweep = joint
                                     plane-sweep volume; patchmatch =
                                     checkerboard PatchMatch, the reference's
                                     openMVS default; with --sgm it runs the
                                     sweep with SGM)
  --mesh                             mesh the dense cloud
  --no-decimate                      skip mesh decimation
  --refine-mesh                      photometric mesh refinement (may also
                                     degrade the mesh, as the reference warns)
  --stats                            write statistics CSVs + resource samples
  --artifacts                        keep debug artifacts (keypoints, matches,
                                     depth maps)
  --stage-times                      time the stages with host-clock spans
                                     (they do not synchronise the cards: a
                                     stage's trailing device work falls to
                                     the next) and log each stage's wall, the
                                     time in collectives, the counters (LM
                                     iterations, SfM starts) and the kernels'
                                     launch counts at the end
  --help

On one host, one process drives every card (the default). Across hosts,
under torchrun (one process per rank, e.g. python -m torch.distributed.run
--standalone --nproc-per-node=2 -m sfm_mvs_pipeline_tpu_torch ...) matching,
bundle adjustment and the depth maps run sharded over the ranks: nccl when
every rank has its own card, gloo when ranks share one or run on the CPU."""
    )


def prepare_working_dir(path: str) -> None:
    """Wipe + recreate like the reference (PhotogrammetrieCli.cpp:399-402)."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)


def main(args: AppArgs) -> int:
    if args.is_flag("help"):
        print_usage()
        return 0
    import torch.distributed as dist

    # first: under torchrun, join the group and take this rank's cards
    joined = not dist.is_initialized()
    distributed.initialize_distributed(
        backend="gloo" if _device_name(args).startswith("cpu") else None)
    try:
        return _main(args)
    finally:
        if joined:
            distributed.shutdown_distributed()


def _main(args: AppArgs) -> int:
    out_dir = args.get("out", "out")
    image_args = args.get_all("image")
    resume = args.get("resume")
    if not image_args and not resume:
        log.error("no -Pimage given")
        print_usage()
        return 2
    mesh = _device(args)  # before the workdir wipe: a run without its card fails first
    writer = distributed.process_index() == 0

    # a resume checkpoint inside the output dir (resuming from the previous
    # run's own scene.npz) must survive the workdir wipe below: rank 0
    # stashes it in a temporary directory, removed again when the run ends
    stash = stashed = None
    if resume and os.path.exists(resume):
        r_real = os.path.realpath(resume)
        out_real = os.path.realpath(out_dir)
        if writer and (r_real == out_real or r_real.startswith(out_real + os.sep)):
            stash = tempfile.mkdtemp(prefix="sfm_resume_")
            for p in (resume, resume + ".json"):
                if os.path.exists(p):
                    shutil.copy2(p, stash)
        stashed = distributed.broadcast_object(stash)
        if stashed:
            args.params["resume"] = [os.path.join(stashed, os.path.basename(resume))]
    try:
        if writer:
            prepare_working_dir(out_dir)
        distributed.barrier()  # no rank writes or reads -Pout= before the wipe
        sampler = None
        if args.is_flag("stats") and writer:
            from sfm_mvs_pipeline_tpu_torch.utils.stats import ResourceSampler

            sampler = ResourceSampler(os.path.join(out_dir, "app.stat.csv"))
            sampler.start()
        if args.is_flag("stage-times"):
            stage_timer.enable()
        try:
            if args.get("resume"):
                return _run_profiled(args, mesh, lambda: _run_resumed(
                    args, out_dir, args.get("resume"), mesh))
            return _run_profiled(args, mesh, lambda: _run_inner(args, out_dir, image_args, mesh))
        finally:
            if sampler:
                sampler.stop()
            if args.is_flag("stage-times"):
                _log_stage_times()
                stage_timer.enable(False)
    finally:
        if stashed:
            distributed.barrier()  # every rank has read the stashed checkpoint
            if writer:
                shutil.rmtree(stashed, ignore_errors=True)


def _log_stage_times() -> None:
    """--stage-times: each stage's wall (collectives included), the
    counters, and each kernel's launches in this process, one line each,
    and, where kernels ran on the cards, each kernel's launches by card."""
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel, pm_kernel, sgm_kernel

    split = stage_timer.report()
    log.info("stage times: " + "; ".join(f"{k} {t:.3f} s x{n}" for k, (t, n) in split.items()))
    log.info("counters: " + ", ".join(f"{k} {n}" for k, n in stage_timer.counters().items()))
    kernels = (match_kernel.two_nn_batch_fused, match_kernel.two_nn_exact_batch,
               sgm_kernel.sgm_bidir, sgm_kernel.sgm_hpair, sgm_kernel.sgm_dir_acc,
               pm_kernel.pm_score_rect)
    log.info("kernel launches: " + ", ".join(f"{k.__name__} {k.launches}" for k in kernels))
    if any(getattr(k, "by_card", None) for k in kernels):
        log.info("kernel launches by card: " + ", ".join(
            f"{k.__name__} " + "/".join(f"{c}:{n}" for c, n in sorted(k.by_card.items()))
            for k in kernels))


def _device_name(args: AppArgs) -> str:
    return args.get("device", "cuda").lower()


def _device(args: AppArgs):
    """The Mesh of -Pdevice=cuda|cpu|<list> (default cuda), the port's
    counterpart of JAX_PLATFORMS and jax.devices(): resolve_devices' rules.
    cuda without a card, or a card that does not exist, raises."""
    from sfm_mvs_pipeline_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(_device_name(args))


def _log_devices(mesh) -> None:
    """One line a device of the mesh (under torchrun the rank's one
    device, the line tagged with the rank): its card's name and UUID."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import _card_id

    for i, dev in enumerate(mesh.devices):
        where = (f"{torch.cuda.get_device_name(dev)}, {_card_id(dev)}" if dev.type == "cuda"
                 else "cpu")
        log.info(f"device: {where}" if len(mesh) == 1 else
                 f"mesh device {i} of {len(mesh)}: {dev}, {where}")


def _run_profiled(args: AppArgs, mesh, run) -> int:
    """run() (a run from images or resumed), under torch.profiler when
    -Pprofile=<dir> is given: CPU and (on the cards) CUDA activity, written
    as a Chrome trace into <dir> (trace.json; under torchrun one a rank,
    trace.rank<r>.json)."""
    profile_dir = args.get("profile")
    if not profile_dir:
        return run()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if mesh.first.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        rc = run()
    os.makedirs(profile_dir, exist_ok=True)
    rank, world = distributed.process_index(), distributed.process_count()
    path = os.path.join(profile_dir, f"trace.rank{rank}.json" if world > 1 else "trace.json")
    prof.export_chrome_trace(path)
    log.info(f"profiler trace written to {path}")
    return rc


def _run_inner(args: AppArgs, out_dir: str, image_args: list, mesh) -> int:
    import torch

    from sfm_mvs_pipeline_tpu_torch.models.cameras import make_intrinsics
    from sfm_mvs_pipeline_tpu_torch.models.scene import Scene
    from sfm_mvs_pipeline_tpu_torch.ops.pairs import make_pairs
    from sfm_mvs_pipeline_tpu_torch.sfm.ba import BAConfig
    from sfm_mvs_pipeline_tpu_torch.sfm.incremental import SfMConfig, reconstruct
    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import save_scene
    from sfm_mvs_pipeline_tpu_torch.utils.images import (
        colorize_points,
        list_images,
        load_gray_batch,
    )
    from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import stage
    from sfm_mvs_pipeline_tpu_torch.utils.stats import write_reprojection_stats

    _log_devices(mesh)
    dev = mesh.first

    # ---- enumerate images (dir or repeated files, sorted)
    paths = []
    for ia in image_args:
        if os.path.isdir(ia):
            paths.extend(list_images(ia))
        else:
            paths.append(ia)
    log.info(f"{len(paths)} input images")
    if len(paths) < 2:
        log.error("need at least two images")
        return 2
    with stage("load"):
        imgs, (w, h) = load_gray_batch(paths)

    # ---- features; limit 0 = "unlimited" like cv::SIFT::create(0, ...)
    # (PhotogrammetrieCli.cpp:345, max 2^18)
    detector = args.get("feature-detector", "sift").lower()
    if detector not in ("sift", "orb"):
        log.error(f"unknown feature detector: {detector}")
        return 2
    requested_limit = args.get_int("feature-limit", 10000)
    feature_limit = requested_limit if requested_limit > 0 else 1 << 18
    feature_limit = min(feature_limit, 1 << 18)
    explicit = args.get("feature-limit") is not None
    warn_req = requested_limit if (explicit and requested_limit > 0) else None
    log.info(f"extracting {detector} features (limit {feature_limit})")
    cap_env = _feature_cap(feature_limit, w, h, warn_req)
    with stage("features"):
        kps, descs, valid = _extract_features(detector, torch.as_tensor(imgs, device=dev), cap_env)
    log.info(f"features per image: {[int(v.sum()) for v in valid]}")

    # ---- scene + camera model
    camera_model = _normalize_camera_model(args.get("camera-model", "simple-radial"))
    intr = make_intrinsics(w, h).numpy().astype(np.float64)
    scene = Scene.create(paths, (w, h), kps, descs, valid, intr, camera_model=camera_model)

    # ---- pair policy (ref strategy selection PhotogrammetrieCli.cpp:320-340)
    grid_len = args.get_int("feature-gridlength", 0)
    seq = args.get_int("feature-sequence", 0)
    if grid_len > 0:
        pairs = make_pairs("grid", scene.n_shots, max(seq, 2), grid_len)
        log.info(f"grid pairing: {len(pairs)} pairs")
    elif seq > 0:
        pairs = make_pairs("video", scene.n_shots, seq)
        log.info(f"sequence pairing: {len(pairs)} pairs")
    else:
        pairs = make_pairs("unordered", scene.n_shots)
        log.info(f"unordered pairing: {len(pairs)} pairs")

    # ---- SfM
    cfg = SfMConfig(
        min_match_count=args.get_int("match-threshold", 20),
        baseline_min_matches=args.get_int("baseline-homography-threshold", 100),
        min_homography_inlier_ratio=args.get_float("homography-inlier-ratio-threshold", 0.4),
        min_pose_inlier_ratio=args.get_float("pose-inlier-ratio-threshold", 0.4),
        ransac_matching_threshold=args.get_float("ransac-matching-threshold", -3.0),
        ransac_baseline_threshold=args.get_float("ransac-baseline-threshold", -1.0),
        ransac_pose_threshold=args.get_float("ransac-pose-threshold", -8.0),
        max_reprojection_error=args.get_float("reprojection-error-threshold", 10.0),
        point_merge_distance=args.get_float("pointcloud-point-merge-distance", 0.01),
        feature_merge_distance=args.get_float("pointcloud-feature-merge-distance", 20.0),
        distinct_matches=args.is_flag("distinct-matches"),
        matcher_method=(
            "flann" if args.get("feature-matcher", "bf").lower() == "flann" else "bf"
        ),
        exact_match=_match_precision(args) == "exact",
        binary_descriptors=(detector == "orb"),
        ba=BAConfig(),
    )
    with stage("sfm"):
        stats = reconstruct(scene, pairs, cfg, log=logging.AppLogger("SfM").info, devices=mesh)
    log.info(f"SfM done: {stats}")
    if stats.get("baseline") is None:
        log.error("reconstruction failed: no baseline pair")
        return 1

    # ---- outputs (ref: runSfM artifact block PhotogrammetrieCli.cpp:113-137),
    # written by rank 0 alone
    if args.is_flag("colored"):
        colorize_points(scene)
    if distributed.process_index() == 0:
        with stage("outputs"):
            _write_sparse(scene, out_dir, args.is_flag("colored"))
            if args.is_flag("stats"):
                st = write_reprojection_stats(scene, out_dir)
                log.info(f"reprojection error: mean {st['mean']:.3f} median {st['median']:.3f}")
            if args.is_flag("artifacts"):
                _write_artifacts(scene, out_dir, dev)
            # durable scene checkpoint, the same format the JAX package writes
            save_scene(scene, os.path.join(out_dir, "scene.npz"))
    if args.is_flag("dense"):
        _run_dense(args, scene, out_dir, mesh)
    log.info("done")
    return 0


def _run_dense(args: AppArgs, scene, out_dir: str, mesh) -> None:
    """The dense branch (ref: MVS stage of PhotogrammetrieCli.cpp:229-240)."""
    from sfm_mvs_pipeline_tpu_torch.mvs.pipeline import MVSConfig, run_mvs
    from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import stage

    cfg = MVSConfig(
        use_sgm=args.is_flag("sgm"),
        method=_dense_method(args),
        mesh=args.is_flag("mesh"),
        decimate=not args.is_flag("no-decimate"),
        refine_mesh=args.is_flag("refine-mesh"),
        texture=args.is_flag("colored"),
        keep_artifacts=args.is_flag("artifacts"),
    )
    with stage("dense"):
        run_mvs(scene, out_dir, cfg, log=logging.AppLogger("MVS").info, devices=mesh)


def _run_resumed(args: AppArgs, out_dir: str, resume_path: str, mesh) -> int:
    """Resume from a scene checkpoint: re-run exports and/or dense MVS
    without repeating SfM (reference mvs.bin parity)."""
    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene, save_scene
    from sfm_mvs_pipeline_tpu_torch.utils.images import colorize_points

    scene = load_scene(resume_path)
    log.info(f"resumed scene: {scene.n_shots} shots, {scene.n_points} points, "
             f"{scene.n_obs} observations")
    if args.is_flag("colored"):
        colorize_points(scene)
    if distributed.process_index() == 0:
        # re-save the checkpoint into the (wiped) workdir so resumed runs keep
        # the artifact contract of full runs and can themselves be resumed
        save_scene(scene, os.path.join(out_dir, "scene.npz"))
        _write_sparse(scene, out_dir, args.is_flag("colored"))
    if args.is_flag("dense"):
        _run_dense(args, scene, out_dir, mesh)
    log.info("done")
    return 0


def _write_sparse(scene, out_dir: str, colored: bool) -> None:
    """pointcloud_sparse.ply (the live points, colored when asked) and
    cameras_recovered.ply (a frustum a recovered shot)."""
    from sfm_mvs_pipeline_tpu_torch.utils.ply import write_camera_frustums_ply, write_ply_points

    live = scene.point_valid
    write_ply_points(os.path.join(out_dir, "pointcloud_sparse.ply"), scene.points[live],
                     scene.colors[live] if colored else None)
    write_camera_frustums_ply(os.path.join(out_dir, "cameras_recovered.ply"),
                              scene.poses[scene.recovered], scene.intrinsics[0],
                              scene.image_size)


def _extract_features(detector: str, imgs_d, cap_env: int):
    """(keypoints, descriptors, valid) as host arrays: SIFT with adaptive
    capacity, or ORB at the full capacity with its packed bits expanded to
    +-1 floats (the JAX package's ORB branch; the expansion under the span
    "orb describe", and the counters "orb keypoints", the valid keypoints
    of every view, and "orb slots", capacity times views)."""
    if detector == "sift":
        from sfm_mvs_pipeline_tpu_torch.ops.sift import sift_features

        # start small and escalate x4 only on saturation: the top-k and
        # padded-slot work scales with capacity, not detections
        cap = min(cap_env, 2048)
        while True:
            feats = sift_features(imgs_d, max_features=cap, contrast_threshold=0.09)
            detected = int(feats["valid"].sum(dim=1).max())
            if detected < cap or cap >= cap_env:
                break
            cap = min(cap * 4, cap_env)
            log.info(f"feature capacity saturated ({detected}); escalating to {cap}")
        descs = feats["descriptors"]
    else:
        from sfm_mvs_pipeline_tpu_torch.ops.matching import expand_binary_descriptors
        from sfm_mvs_pipeline_tpu_torch.ops.orb import orb_features

        feats = orb_features(imgs_d, max_features=cap_env)
        with stage_timer.stage("orb describe"):
            descs = expand_binary_descriptors(feats["descriptors"])
    valid = feats["valid"].cpu().numpy()
    if detector == "orb":
        stage_timer.count("orb keypoints", int(valid.sum()))
        stage_timer.count("orb slots", int(valid.size))
    return feats["keypoints"].cpu().numpy(), descs.cpu().numpy(), valid


def _feature_cap(limit: int, w: int, h: int, warn_requested: int | None = None) -> int:
    """Feature capacity: the next power of two covering the limit, bounded
    by the image area (W*H/32, real images detect far fewer extrema) and the
    reference's 2^18 maximum (PhotogrammetrieCli.cpp:430). Warns when an
    explicit user limit is reduced."""
    bound = min(limit, 1 << 18, max(w * h // 32, 256))
    cap = 256
    while cap < bound:
        cap *= 2
    if warn_requested is not None and cap < warn_requested:
        logging.AppLogger("Photogrammetrie").warn(
            f"feature-limit {warn_requested} reduced to capacity {cap} "
            f"(image area {w}x{h} bounds detectable extrema)"
        )
    return cap


def _match_precision(args: AppArgs) -> str:
    """Validated -Pmatch-precision=: fast runs kernel K1 (full fp32 FMAs;
    exact on ORB's +-1 expansion), exact runs kernel K1x (the JAX package's
    exact mode: the bf16x3 split q2_hi.t_hi + q2_lo.t_hi + q2_hi.t_lo on the
    tensor cores; the split's remainders and the dropped lo.lo term bound
    the error by 3 * 2^-16 (|q|^2 + |t|^2) = 4.6e-5 of it on continuous
    descriptors such as SIFT's; ORB descriptors still run K1)."""
    mode = args.get("match-precision", "fast").lower()
    if mode not in ("fast", "exact"):
        raise ValueError(f"unknown -Pmatch-precision={mode} (expected fast|exact)")
    return mode


def _dense_method(args: AppArgs) -> str:
    """Validated -Pdense-method= (typos are rejected, not defaulted)."""
    method = args.get("dense-method", "rect").lower()
    if method not in ("rect", "sweep", "patchmatch"):
        raise ValueError(f"unknown -Pdense-method={method} (expected rect|sweep|patchmatch)")
    return method


def _write_artifacts(scene, out_dir: str, dev) -> None:
    """Debug artifacts mirroring the reference (PhotogrammetrieCli.cpp:139-219):
    keypoint overlays per shot, match lines per recovered pair (from the
    observation table), undistorted images, scene.txt."""
    import cv2

    from sfm_mvs_pipeline_tpu_torch.mvs.pipeline import _undistort_image
    from sfm_mvs_pipeline_tpu_torch.utils.images import load_rgb

    art = os.path.join(out_dir, "artifacts")
    os.makedirs(art, exist_ok=True)
    rgbs = {}
    for s in range(scene.n_shots):
        rgb = load_rgb(scene.image_paths[s], scene.image_size)
        rgbs[s] = rgb
        img = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR).copy()
        for x, y in scene.keypoints[s][scene.feat_valid[s]]:
            cv2.circle(img, (int(x), int(y)), 2, (0, 255, 0), 1)
        cv2.imwrite(os.path.join(art, f"keypoints_{s:04d}.jpg"), img)

    live = scene.obs_w > 0
    by_point = {}
    for o in np.nonzero(live)[0]:
        by_point.setdefault(int(scene.obs_point[o]), []).append(o)
    pair_lines = {}
    for obs_list in by_point.values():
        for i in range(len(obs_list)):
            for j in range(i + 1, len(obs_list)):
                a, b = int(scene.obs_shot[obs_list[i]]), int(scene.obs_shot[obs_list[j]])
                if a == b:
                    continue
                oi, oj = obs_list[i], obs_list[j]
                if a > b:
                    a, b, oi, oj = b, a, oj, oi
                pair_lines.setdefault((a, b), []).append((scene.obs_uv[oi], scene.obs_uv[oj]))
    w, h = scene.image_size
    for (a, b), lines in pair_lines.items():
        if len(lines) < 10:
            continue
        canvas = np.concatenate(
            [cv2.cvtColor(rgbs[a], cv2.COLOR_RGB2BGR), cv2.cvtColor(rgbs[b], cv2.COLOR_RGB2BGR)],
            axis=1,
        ).copy()
        for (ua, va), (ub, vb) in lines[:500]:
            cv2.line(canvas, (int(ua), int(va)), (int(ub) + w, int(vb)), (0, 200, 255), 1)
        cv2.imwrite(os.path.join(art, f"matches_{a:04d}_{b:04d}.jpg"), canvas)

    for s in range(scene.n_shots):
        und = _undistort_image(rgbs[s], scene.intrinsics[scene.cam_of_shot[s]], dev)
        cv2.imwrite(
            os.path.join(art, f"undistorted_{s:04d}.png"),
            cv2.cvtColor(und.astype(np.uint8), cv2.COLOR_RGB2BGR),
        )

    with open(os.path.join(out_dir, "scene.txt"), "w") as f:
        f.write(f"shots: {scene.n_shots}\n")
        f.write(f"points: {scene.n_points}\n")
        f.write(f"observations: {scene.n_obs}\n")
        f.write(f"intrinsics: {scene.intrinsics.tolist()}\n")
        for s in range(scene.n_shots):
            f.write(
                f"shot {s}: {scene.image_paths[s]} recovered={bool(scene.recovered[s])} "
                f"pose={scene.poses[s].round(6).tolist()}\n"
            )


_CAMERA_ALIASES = {
    "simple": "simple", "simpleradial": "simple-radial",
    "simple-radial": "simple-radial", "distortion": "distortion",
    "fixed": "fixed",
}


def _normalize_camera_model(name: str) -> str:
    """Accept the reference run-script spellings (SimpleRadial, Simple,
    Distortion; ref: run-scripts/run-grid-flann.sh)."""
    key = name.replace("_", "").replace("-", "").lower()
    for k in (name.lower(), key):
        if k in _CAMERA_ALIASES:
            return _CAMERA_ALIASES[k]
    raise ValueError(f"unknown camera model: {name}")
