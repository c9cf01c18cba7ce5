"""On-card smoke run of the PyTorch + CUDA port (sfm_mvs_pipeline_tpu_torch).

Needs one CUDA card; exits non-zero without one, and never falls back to
the CPU. Phases, each timed and each fatal on failure:

  1. device + build: builds kernel K1 (the batched 2-NN matcher) and the
     SGM kernels K2a and K2b from sfm_mvs_pipeline_tpu_torch/csrc/, one
     nvcc process per source, started together; prints the ptxas reports.
  2. K1 against its plain PyTorch version on the card at the main path's
     shape (12 shots x 8192 features x 128 dims, all 66 unordered pairs):
     bit-equal idx / best^2 / second^2 and equal ratio-test masks; CUDA-event
     times of both, median of warm runs.
  3. the fast-test: the port's CLI on sample_data/insel with the flags of
     run-scripts/fast-test.sh; 3/3 views, median reprojection < 1 px, the
     three output files, K1 launched.
  4. a real-size run: 12 rendered views at 1920x1080 (f = 1680) with
     -Pfeature-limit=0 over unordered pairs (66 pairs), cold and warm;
     12/12 views, sim(3)-aligned ATE <= 0.1% of the trajectory extent and
     max relative rotation <= 0.25 deg against the renderer's ground truth,
     K1 launched.
  5. K2a and K2b against their plain PyTorch versions on the card at the
     1080p render's rect volume, (H, W, D) = (1080, 1920, 96) f32, random
     costs in [0, 1], P1 = 0.03, P2 = 0.3: bit-equal outputs; CUDA-event
     medians of kernel and plain version.
  6. the dense fast-test: the port's CLI on sample_data/insel with
     --dense --sgm --mesh --colored --stats --artifacts; 3/3 views, dense
     cloud and mesh written with points and faces, K2a launched (insel
     densifies at 360x202, under the staged-SGM gate).
  7. the dense real-size run: the 1080p render of phase 4 through the CLI
     with -Pfeature-limit=0 --dense --sgm --mesh --colored --stats; 12/12
     views, K2b launched, dense accuracy against the renderer's geometry
     (see phase_dense_real_size), the dense wall and its per-stage split.
  8. K3 (the rectified PatchMatch scorer, built in phase 1) against its
     plain PyTorch version on the card at the 1080p render's rect shape:
     C = 6 candidate maps of (H, W) = (1080, 1920), r = 3, maxd as
     derive_max_disp gives it for the render, random rectified images and
     an invalid band in in_n; bit-equal costs; CUDA-event medians of kernel
     and plain version.
  9. the dense fast-test with PatchMatch: insel with --dense
     -Pdense-method=patchmatch --mesh --colored --stats --artifacts; 3/3
     views, dense cloud and mesh with points and faces, K3 launched.
 10. the dense real-size run with PatchMatch: phase 7's scene.npz (or, run
     alone, a fresh SfM of the render) through -Presume= with
     -Pdense-method=patchmatch --dense --mesh --colored --stats; 12/12
     views, K3 launched, dense accuracy at PM_DENSE_SHARE_LIMIT, the dense
     wall and its per-stage split.

Prints the card's name and power limit, one JSON line with the kernel
table, and as its last line {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--phases 1,2,3,4,5,6,7,8,9,10]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = os.path.join(ROOT, "chiprun_out")
K1_SOURCE = "sfm_mvs_pipeline_tpu_torch/csrc/match_kernel.cu"
K1_REPLACES = "sfm_mvs_pipeline_tpu/ops/pallas/match_kernel.py:159"
K2_SOURCE = "sfm_mvs_pipeline_tpu_torch/csrc/sgm_kernel.cu"
K2A_REPLACES = "sfm_mvs_pipeline_tpu/ops/pallas/sgm_kernel.py:43"
K2B_REPLACES = "sfm_mvs_pipeline_tpu/ops/pallas/sgm_kernel.py:155"
K3_SOURCE = "sfm_mvs_pipeline_tpu_torch/csrc/pm_kernel.cu"
K3_REPLACES = "sfm_mvs_pipeline_tpu/ops/pallas/pm_kernel.py:46"
ALL_PHASES = set(range(1, 11))
DENSE_PARTS = ["load + undistort", "rect sweep", "sweep", "patchmatch", "sgm", "consensus",
               "fusion", "mesh", "refine", "texture"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def say(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


def run_cli(argv: list[str], log_name: str) -> tuple[int, str, float]:
    """Run the port's CLI in-process; returns (rc, log text, wall s). The
    wall ends with a device synchronise."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.cli.app import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, log_name), "w") as f:
        f.write(text)
    return rc, text, wall


def check_outputs(out_dir: str) -> tuple[object, float]:
    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene
    from sfm_mvs_pipeline_tpu_torch.utils.stats import reprojection_errors

    for name in ("pointcloud_sparse.ply", "cameras_recovered.ply", "scene.npz"):
        if not os.path.exists(os.path.join(out_dir, name)):
            raise AssertionError(f"{name} not written")
    scene = load_scene(os.path.join(out_dir, "scene.npz"))
    med = float(np.median(reprojection_errors(scene)))
    return scene, med


def timed(fn, reps=5) -> float:
    """Median CUDA-event time of `reps` calls of fn, in ms."""
    import torch

    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def phase_kernel(card: str) -> dict:
    import torch

    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import ratio_test_mask, two_nn_batch

    S, F, D = 12, 8192, 128
    rng = np.random.default_rng(0)
    desc = rng.integers(0, 256, size=(S, F, D)).astype(np.float32)
    # duplicated target rows: exact distance ties for the tie rule
    for s in range(S):
        src = rng.integers(0, F, size=F // 16)
        dst = rng.integers(0, F, size=F // 16)
        desc[s, dst] = desc[s, src]
    valid = rng.random((S, F)) > 0.05
    pairs = np.array([(a, b) for a in range(S) for b in range(a + 1, S)], np.int32)
    dev = torch.device("cuda")
    d_t = torch.from_numpy(desc).to(dev)
    v_t = torch.from_numpy(valid).to(dev)
    p_t = torch.from_numpy(pairs).to(dev)

    def kern():
        return K.two_nn_batch_fused(d_t, v_t, p_t)

    def plain():
        return two_nn_batch(d_t, v_t, p_t)

    ik, bk, sk = kern()
    ip, bp, sp = plain()
    torch.cuda.synchronize()
    vq = v_t[p_t[:, 0].long()]
    if not torch.equal(ik, ip):
        n = int((ik != ip).sum())
        raise AssertionError(f"K1 idx differs from the plain version at {n} entries")
    if not (torch.equal(bk, bp) and torch.equal(sk, sp)):
        raise AssertionError("K1 distances are not bit-equal to the plain version")
    if not torch.equal(ratio_test_mask(bk, sk, vq), ratio_test_mask(bp, sp, vq)):
        raise AssertionError("K1 ratio-test masks differ from the plain version")
    err = float(torch.maximum((bk - bp).abs().max(), (sk - sp).abs().max()))
    n_ties = int((bp == sp).sum())

    # alternate plain / kernel so neither gets a warmer card
    ms_p1 = timed(plain)
    ms_k1 = timed(kern)
    ms_k2 = timed(kern)
    ms_p2 = timed(plain)
    ms_k = float(np.median([ms_k1, ms_k2]))
    ms_p = float(np.median([ms_p1, ms_p2]))
    P = len(pairs)
    gflop = 2.0 * F * F * D * P / 1e9
    say(card, f"K1 bit-equal to plain at S={S} F={F} D={D} P={P} "
              f"(max abs err {err}, {n_ties} tied best/second entries)")
    say(card, f"K1 {ms_k1:.3f}/{ms_k2:.3f} ms, plain {ms_p1:.3f}/{ms_p2:.3f} ms "
              f"(median of 5 each); K1 {P / ms_k * 1e3:.1f} pairs/s "
              f"{gflop / ms_k:.2f} TFLOP/s, plain {P / ms_p * 1e3:.1f} pairs/s")
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p}


def phase_fast_test(card: str) -> None:
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out-fast-test")
        argv = ["-Ploglevel=0", "-Prun=photogrammetrie",
                f"-Pimage={os.path.join(ROOT, 'sample_data', 'insel')}", f"-Pout={out}"]
        K.two_nn_batch_fused.launches = 0
        rc, log, wall = run_cli(argv, "chip_smoke_fast_test.log")
        launches = K.two_nn_batch_fused.launches
        if rc != 0:
            raise AssertionError(f"fast-test CLI exited {rc}")
        scene, med = check_outputs(out)
        n_rec = int(scene.recovered.sum())
        say(card, f"fast-test: rc 0, {n_rec}/{scene.n_shots} views, median "
                  f"reprojection {med:.4f} px, {int(scene.point_valid.sum())} points, "
                  f"K1 launches {launches}, wall {wall:.2f} s")
        if n_rec != 3 or scene.n_shots != 3:
            raise AssertionError(f"fast-test recovered {n_rec}/3 views")
        if not med < 1.0:
            raise AssertionError(f"fast-test median reprojection {med} px")
        if launches <= 0:
            raise AssertionError("fast-test never launched K1")


def phase_real_size(card: str, n_views=12, h=1080, w=1920, f=1680.0) -> int:
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np
    from sfm_mvs_pipeline_tpu_torch.utils.metrics import trajectory_compare
    from sfm_mvs_pipeline_tpu_torch.utils.synth import render_views

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "views")
        _, gt_R, gt_C = render_views(data, n_views, h, w, f)
        say(card, f"rendered {n_views} views at {w}x{h} in {time.perf_counter() - t0:.1f} s")
        launches = 0
        walls = []
        for run in ("cold", "warm"):
            out = os.path.join(tmp, f"out-{run}")
            argv = ["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out}",
                    "-Pfeature-limit=0"]
            K.two_nn_batch_fused.launches = 0
            rc, log, wall = run_cli(argv, f"chip_smoke_real_size_{run}.log")
            if run == "cold":
                launches = K.two_nn_batch_fused.launches
            walls.append(wall)
            if rc != 0:
                raise AssertionError(f"real-size CLI ({run}) exited {rc}")
            scene, med = check_outputs(out)
            rec = np.nonzero(scene.recovered)[0]
            feats = [int(v) for v in scene.feat_valid.sum(axis=1)]
            est_R = aa_to_rotmat_np(scene.poses[rec, :3])
            est_C = -np.einsum("sji,sj->si", est_R, scene.poses[rec, 3:])
            cmp = trajectory_compare(est_C, est_R, gt_C[rec], gt_R[rec])
            extent = float(np.linalg.norm(gt_C[rec][-1] - gt_C[rec][0]))
            rel_ate = cmp["ate_rmse"] / extent
            ba = re.findall(r"BA #(\d+): .*\((\d+) iters, rms ([0-9.]+) px, table (\w+)\)", log)
            pairs_done = re.findall(r"done_pairs': (\d+)", log)
            say(card, f"real-size {run}: {len(rec)}/{n_views} views, features per image "
                      f"{feats}, ATE {rel_ate:.5%} of extent, max rel rot "
                      f"{cmp['max_rel_rot_deg']:.4f} deg, median reprojection {med:.4f} px, "
                      f"done pairs {pairs_done}, wall {wall:.2f} s")
            say(card, "real-size BA runs (#, iters, rms px, table_kind): "
                      + "; ".join(",".join(b) for b in ba))
            if len(rec) != n_views:
                raise AssertionError(f"real-size recovered {len(rec)}/{n_views} views")
            if not rel_ate <= 0.001:
                raise AssertionError(f"real-size ATE {rel_ate:.4%} of extent > 0.1%")
            if not cmp["max_rel_rot_deg"] <= 0.25:
                raise AssertionError(f"real-size max rel rot {cmp['max_rel_rot_deg']} deg")
            if K.two_nn_batch_fused.launches <= 0:
                raise AssertionError(f"real-size ({run}) never launched K1")
        say(card, f"real-size wall: cold {walls[0]:.2f} s, warm {walls[1]:.2f} s")
    return launches


def phase_sgm_kernels(card: str) -> tuple[dict, dict]:
    """K2a and K2b against their plain versions at the 1080p rect volume.
    K2a is timed as sgm_aggregate calls it (both axes); K2b as
    sgm_staged_hwd calls it (bf16 rounding, zeroed accumulator, four
    directions). Tolerance 0: both kernels keep the plain order of every
    add, subtract and min."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.mvs.sgm import sgm_bidir_plain, sgm_dir_acc_plain, staged_sum
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    H, W, D, p1, p2 = 1080, 1920, 96, 0.03, 0.3
    gen = torch.Generator(device="cuda").manual_seed(0)
    cost = torch.rand((H, W, D), generator=gen, device="cuda", dtype=torch.float32)

    def k2a():
        return [K2.sgm_bidir(cost, p1, p2, axis=a) for a in (1, 0)]

    def p2a():
        return [sgm_bidir_plain(cost, p1, p2, a) for a in (1, 0)]

    def k2b():
        return K2.sgm_staged_hwd(cost, p1, p2)

    def p2b():
        return staged_sum(cost, p1, p2, sgm_dir_acc_plain)

    results = []
    for name, kern, plain, wrap in (("K2a", k2a, p2a, lambda x: x), ("K2b", k2b, p2b, lambda x: [x])):
        outs_k, outs_p = wrap(kern()), wrap(plain())
        torch.cuda.synchronize()
        err = 0.0
        for ok, op in zip(outs_k, outs_p):
            if not bool(torch.isfinite(ok).all()):
                raise AssertionError(f"{name} output has non-finite values")
            err = max(err, float((ok - op).abs().max()))
            if not torch.equal(ok, op):
                n = int((ok != op).sum())
                raise AssertionError(f"{name} differs from its plain version at {n} entries "
                                     f"(max abs err {err})")
        del outs_k, outs_p
        ms_p1 = timed(plain, reps=3)
        ms_k1 = timed(kern, reps=3)
        ms_k2 = timed(kern, reps=3)
        ms_p2 = timed(plain, reps=3)
        ms_k = float(np.median([ms_k1, ms_k2]))
        ms_p = float(np.median([ms_p1, ms_p2]))
        say(card, f"{name} bit-equal to plain at (H, W, D) = ({H}, {W}, {D}), P1 {p1} P2 {p2} "
                  f"(max abs err {err}); kernel {ms_k1:.3f}/{ms_k2:.3f} ms, plain "
                  f"{ms_p1:.3f}/{ms_p2:.3f} ms (median of 3 each)")
        results.append({"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p})
    return results[0], results[1]


def ply_counts(path: str) -> tuple[int, int]:
    from sfm_mvs_pipeline_tpu_torch.utils.ply import read_ply

    if not os.path.exists(path):
        raise AssertionError(f"{os.path.basename(path)} not written")
    ply = read_ply(path)
    pts = np.asarray(ply["points"])
    if len(pts) and not np.isfinite(pts).all():
        raise AssertionError(f"{os.path.basename(path)} has non-finite points")
    faces = ply.get("faces")
    return len(pts), 0 if faces is None else len(faces)


def phase_dense_fast_test(card: str) -> int:
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out-dense-fast-test")
        argv = ["-Prun=photogrammetrie", f"-Pimage={os.path.join(ROOT, 'sample_data', 'insel')}",
                f"-Pout={out}", "--dense", "--sgm", "--mesh", "--colored", "--stats", "--artifacts"]
        K2.sgm_bidir.launches = 0
        rc, log, wall = run_cli(argv, "chip_smoke_dense_fast_test.log")
        launches = K2.sgm_bidir.launches
        if rc != 0:
            raise AssertionError(f"dense fast-test CLI exited {rc}")
        scene, med = check_outputs(out)
        n_rec = int(scene.recovered.sum())
        n_pts, _ = ply_counts(os.path.join(out, "pointcloud_dense.ply"))
        n_vm, n_faces = ply_counts(os.path.join(out, "mesh_dense.ply"))
        depth_files = sorted(f for f in os.listdir(out) if f.startswith("depth_"))
        say(card, f"dense fast-test: rc 0, {n_rec}/{scene.n_shots} views, {n_pts} dense points, "
                  f"mesh {n_vm} vertices {n_faces} faces, {len(depth_files)} depth maps, "
                  f"K2a launches {launches}, wall {wall:.2f} s")
        if n_rec != 3 or scene.n_shots != 3:
            raise AssertionError(f"dense fast-test recovered {n_rec}/3 views")
        if n_pts <= 0 or n_faces <= 0:
            raise AssertionError(f"dense fast-test: {n_pts} dense points, {n_faces} faces")
        if not os.path.exists(os.path.join(out, "mesh_dense.png")) or len(depth_files) != 3:
            raise AssertionError("dense fast-test: texture atlas or depth maps missing")
        if launches <= 0:
            raise AssertionError("dense fast-test never launched K2a")
    return launches


def sim3_from_cameras(est_R, est_C, gt_R, gt_C):
    """(s, R, t) with X_gt = s R X_est + t. The rotation comes from the
    camera orientations (R = mean of gt_R_i^T est_R_i, projected onto
    SO(3)), scale and translation from the centres by least squares: the
    render's camera centres lie on one line, so centres alone leave the
    roll about that line free."""
    U, _, Vt = np.linalg.svd(np.einsum("sji,sjk->ik", gt_R, est_R))
    R = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    y = est_C @ R.T
    yc, gc = y - y.mean(0), gt_C - gt_C.mean(0)
    s = float((yc * gc).sum() / (yc * yc).sum())
    return s, R, gt_C.mean(0) - s * y.mean(0)


def surface_share(points_gt: np.ndarray, rel: float = 0.01) -> float:
    """Share of points within `rel` of depth of the render's surfaces
    (utils/synth.py): the z = 10 plane, or the z = 7 disc of radius 2
    centred at (2, 0), with 1% slack on the radius for rim pixels. The
    cameras sit at z ~ 0 looking along +z, so world z is depth to 1%."""
    x, y, z = points_gt.T
    on_plane = np.abs(z - 10.0) <= rel * 10.0
    on_disc = ((x - 2.0) ** 2 + y ** 2 <= (2.0 * 1.01) ** 2) & (np.abs(z - 7.0) <= rel * 7.0)
    return float(np.mean(on_plane | on_disc)) if len(points_gt) else 0.0


def dense_accuracy(out_dir: str, gt_R, gt_C):
    """(share of dense points on the rendered surfaces, number of points)
    of a CLI output dir, after the sim(3) of the recovered cameras."""
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np
    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene
    from sfm_mvs_pipeline_tpu_torch.utils.ply import read_ply

    scene = load_scene(os.path.join(out_dir, "scene.npz"))
    rec = np.nonzero(scene.recovered)[0]
    est_R = aa_to_rotmat_np(scene.poses[rec, :3])
    est_C = -np.einsum("sji,sj->si", est_R, scene.poses[rec, 3:])
    s, R, t = sim3_from_cameras(est_R, est_C, gt_R[rec], gt_C[rec])
    pts = np.asarray(read_ply(os.path.join(out_dir, "pointcloud_dense.ply"))["points"], np.float64)
    return surface_share(s * pts @ R.T + t), len(pts)


# Limit of phase 7: the JAX package's CLI (--dense --sgm, rect engine) on
# the CPU, on this render cut to 480x270 (f = 420), recovered 12/12 views
# and put 0.9917 of its 202,281 fused points within 1% of depth of the
# surfaces. The limit leaves ~4 points of room for the full size (the
# staged route's bf16 cost, 16x the pixels per surface patch) and the
# port's own arithmetic on the card, and is not below 0.9.
DENSE_SHARE_LIMIT = 0.95


def render_once(card: str, work: str, n_views: int, h: int, w: int, f: float):
    """The render of phases 7 and 10 in `work`, made once: (image dir,
    gt_R, gt_C)."""
    from sfm_mvs_pipeline_tpu_torch.utils.synth import render_views

    data = os.path.join(work, f"views_{n_views}_{w}x{h}")
    gt_file = data + "_gt.npz"
    if not os.path.exists(gt_file):
        t0 = time.perf_counter()
        _, gt_R, gt_C = render_views(data, n_views, h, w, f)
        np.savez(gt_file, R=gt_R, C=gt_C)
        say(card, f"rendered {n_views} views at {w}x{h} in {time.perf_counter() - t0:.1f} s")
    gt = np.load(gt_file)
    return data, gt["R"], gt["C"]


def run_dense_cli(card: str, argv: list[str], log_name: str, counter, n_views: int,
                  gt_R, gt_C, out: str, limit: float, label: str) -> int:
    """One dense CLI run of the render under the stage timers, checked:
    all views, points and faces, dense accuracy at `limit`, the kernel whose
    wrapper is `counter` launched. Returns the launch count."""
    from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

    counter.launches = 0
    stage_timer.enable()
    try:
        rc, log, wall = run_cli(argv, log_name)
        split = stage_timer.report()
    finally:
        stage_timer.enable(False)
    launches = counter.launches
    if rc != 0:
        raise AssertionError(f"{label} CLI exited {rc}")
    scene, med = check_outputs(out)
    n_rec = int(scene.recovered.sum())
    n_vm, n_faces = ply_counts(os.path.join(out, "mesh_dense.ply"))
    share, n_pts = dense_accuracy(out, gt_R, gt_C)
    dense_s = split.get("dense", (float("nan"), 0))[0]
    rest = dense_s - sum(split.get(k, (0.0, 0))[0] for k in DENSE_PARTS)
    say(card, f"{label}: {n_rec}/{n_views} views, {n_pts} dense points, "
              f"{share:.4%} within 1% of depth of the surfaces (limit {limit:.0%}), "
              f"mesh {n_vm} vertices {n_faces} faces, {counter.__name__} launches {launches}, "
              f"CLI wall {wall:.2f} s")
    say(card, f"{label} dense stage wall {dense_s:.3f} s (synchronising stage timers): "
              + "; ".join(f"{k} {split[k][0]:.3f} s x{split[k][1]}"
                          for k in DENSE_PARTS if k in split)
              + f"; other {rest:.3f} s")
    if n_rec != n_views:
        raise AssertionError(f"{label} recovered {n_rec}/{n_views} views")
    if n_pts <= 0 or n_faces <= 0:
        raise AssertionError(f"{label}: {n_pts} dense points, {n_faces} faces")
    if not share >= limit:
        raise AssertionError(f"{label}: {share:.4%} of points on the surfaces")
    if launches <= 0:
        raise AssertionError(f"{label} never launched {counter.__name__}")
    return launches


def phase_dense_real_size(card: str, work: str, n_views=12, h=1080, w=1920, f=1680.0) -> int:
    """The 1080p render through the CLI's dense path (staged SGM, K2b).

    Accuracy: the sim(3) from the recovered cameras to the renderer's maps
    the fused cloud into the render's frame; the share of points within 1%
    of depth of the rendered surface must reach DENSE_SHARE_LIMIT (its
    comment says how it was set). The render runs at full 1920x1080 with
    all 12 views. The output stays in `work` for phase 10."""
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    data, gt_R, gt_C = render_once(card, work, n_views, h, w, f)
    out = os.path.join(work, "out-dense")
    argv = ["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out}", "-Pfeature-limit=0",
            "--dense", "--sgm", "--mesh", "--colored", "--stats"]
    return run_dense_cli(card, argv, "chip_smoke_dense_real_size.log", K2.sgm_dir_acc, n_views,
                         gt_R, gt_C, out, DENSE_SHARE_LIMIT, "dense real-size")


def render_max_disp(n_views=12, h=1080, w=1920, f=1680.0) -> tuple[int, float]:
    """(maxd, z_min) that derive_max_disp gives the render's first view
    with its 5 nearest views as neighbours, from the renderer's cameras and
    a depth range of the nearest surface (z = 7) padded like depth_range
    (a quarter of the 7..10 span)."""
    from sfm_mvs_pipeline_tpu_torch.mvs.rectified import derive_max_disp
    from sfm_mvs_pipeline_tpu_torch.ops.pose import rotmat_to_aa
    from sfm_mvs_pipeline_tpu_torch.utils.synth import render_views

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        _, gt_R, gt_C = render_views(tmp, n_views, 8, 8, f * 8 / w)  # cameras only
    poses = np.concatenate([rotmat_to_aa(torch.from_numpy(gt_R)).numpy(),
                            -np.einsum("sij,sj->si", gt_R, gt_C)], axis=1)
    z_min = 7.0 - 0.25 * (10.0 - 7.0)
    return derive_max_disp(poses[0], poses[1:6], f, z_min, w), z_min


def phase_pm_kernel(card: str) -> dict:
    """K3 against its plain version at the 1080p render's rect shape.
    Tolerance 0: K3 rounds every multiply, add, divide and square root as
    the plain version's separate torch ops do, in the same order."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.mvs.patchmatch import pm_score_rect_plain
    from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import window_stats
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3

    C, H, W, r = 6, 1080, 1920, 3
    maxd, z_min = render_max_disp()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda", dtype=torch.float32)

    ref, nbr = rand(H, W), rand(H, W)
    in_n = rand(H, W) > 0.02
    in_n[:, :40] = False  # the rectified neighbour's invalid left band
    in_n[500:520, 900:1300] = False
    r_mean, r_var = window_stats(ref, r)
    cands_rand = rand(C, H, W) * maxd  # the random init: every disparity in [0, maxd]
    # a converged state: a smooth disparity field per candidate
    xs = torch.arange(W, device="cuda", dtype=torch.float32)
    cands_smooth = (200.0 + 100.0 * torch.sin(xs / 300.0))[None, None] + 0.5 * rand(C, H, W)
    args = (ref, nbr, in_n, r_mean, r_var)
    res = {}
    for name, cands in (("random", cands_rand), ("smooth", cands_smooth)):
        def kern():
            return K3.pm_score_rect(cands, *args, maxd=maxd, window_radius=r)

        def plain():
            return pm_score_rect_plain(cands, *args, maxd=maxd, window_radius=r)

        ok, op = kern(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(ok).all()):
            raise AssertionError("K3 output has non-finite values")
        err = float((ok - op).abs().max())
        if not torch.equal(ok, op):
            n = int((ok != op).sum())
            raise AssertionError(f"K3 differs from its plain version at {n} entries "
                                 f"(max abs err {err})")
        n_one = int((ok == 1).sum())
        del ok, op
        ms_p1 = timed(plain, reps=3)
        ms_k1 = timed(kern, reps=5)
        ms_k2 = timed(kern, reps=5)
        ms_p2 = timed(plain, reps=3)
        ms_k = float(np.median([ms_k1, ms_k2]))
        ms_p = float(np.median([ms_p1, ms_p2]))
        say(card, f"K3 bit-equal to plain at C={C} (H, W) = ({H}, {W}) r={r} maxd={maxd} "
                  f"(derive_max_disp, z_min {z_min}), {name} candidates (max abs err {err}, "
                  f"{n_one} costs at 1); kernel {ms_k1:.3f}/{ms_k2:.3f} ms (median of 5), "
                  f"plain {ms_p1:.3f}/{ms_p2:.3f} ms (median of 3)")
        res[name] = {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p}
    return res["random"]


# Limit of phase 10: the port's CPU rehearsal of this phase, on the render
# cut to 480x270 (f = 420), recovered 12/12 views and put 0.9793 of its
# 207,602 fused points within 1% of depth of the surfaces (rectified
# PatchMatch, as on the card). The JAX package's CLI on the CPU, resumed
# from the same scene, takes its warp-based PatchMatch and got 0.9335 of
# 251,544. The limit sits below both, for the full size (4x the disparity
# range for the same 8 iterations of propagation) and the card's draws,
# and is not below 0.9.
PM_DENSE_SHARE_LIMIT = 0.9


def phase_pm_fast_test(card: str) -> int:
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out-pm-fast-test")
        argv = ["-Prun=photogrammetrie", f"-Pimage={os.path.join(ROOT, 'sample_data', 'insel')}",
                f"-Pout={out}", "--dense", "-Pdense-method=patchmatch", "--mesh", "--colored",
                "--stats", "--artifacts"]
        K3.pm_score_rect.launches = 0
        rc, log, wall = run_cli(argv, "chip_smoke_pm_fast_test.log")
        launches = K3.pm_score_rect.launches
        if rc != 0:
            raise AssertionError(f"PatchMatch fast-test CLI exited {rc}")
        scene, med = check_outputs(out)
        n_rec = int(scene.recovered.sum())
        n_pts, _ = ply_counts(os.path.join(out, "pointcloud_dense.ply"))
        n_vm, n_faces = ply_counts(os.path.join(out, "mesh_dense.ply"))
        rect_pm = log.count("(rect-PM)")
        say(card, f"PatchMatch fast-test: rc 0, {n_rec}/{scene.n_shots} views ({rect_pm} by "
                  f"rect-PM), {n_pts} dense points, mesh {n_vm} vertices {n_faces} faces, "
                  f"K3 launches {launches}, wall {wall:.2f} s")
        if n_rec != 3 or scene.n_shots != 3:
            raise AssertionError(f"PatchMatch fast-test recovered {n_rec}/3 views")
        if n_pts <= 0 or n_faces <= 0:
            raise AssertionError(f"PatchMatch fast-test: {n_pts} dense points, {n_faces} faces")
        if launches <= 0:
            raise AssertionError("PatchMatch fast-test never launched K3")
    return launches


def phase_pm_real_size(card: str, work: str, n_views=12, h=1080, w=1920, f=1680.0) -> int:
    """The 1080p render through -Pdense-method=patchmatch (K3), resumed from
    phase 7's scene.npz when phase 7 ran, else from images; the checks of
    phase 7 at PM_DENSE_SHARE_LIMIT."""
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3

    data, gt_R, gt_C = render_once(card, work, n_views, h, w, f)
    scene_npz = os.path.join(work, "out-dense", "scene.npz")
    out = os.path.join(work, "out-pm")
    src = [f"-Presume={scene_npz}"] if os.path.exists(scene_npz) else [
        f"-Pimage={data}", "-Pfeature-limit=0"]
    argv = ["-Prun=photogrammetrie", *src, f"-Pout={out}", "-Pdense-method=patchmatch",
            "--dense", "--mesh", "--colored", "--stats"]
    launches = run_dense_cli(card, argv, "chip_smoke_pm_real_size.log", K3.pm_score_rect,
                             n_views, gt_R, gt_C, out, PM_DENSE_SHARE_LIMIT,
                             "PatchMatch real-size")
    say(card, f"PatchMatch real-size: K3 launches {launches} "
              f"({launches / (5 * n_views):.2f} per pair, 5 neighbours per view)")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(map(str, sorted(ALL_PHASES))))
    phases = {int(p) for p in ap.parse_args().phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = card_line()
    print(card, flush=True)
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import build, match_kernel, pm_kernel, sgm_kernel

    say(card, f"torch {torch.__version__} cuda {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build(match_kernel.SOURCE, sgm_kernel.SOURCE, pm_kernel.SOURCE, verbose=True)
    say(card, f"phase 1: K1, K2a, K2b and K3 built in {time.perf_counter() - t0:.2f} s")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(card, phases, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_phases(card: str, phases: set, work: str) -> int:
    import torch

    entry = {"name": "two_nn_batch_fused", "route": "cuda", "source": K1_SOURCE,
             "replaces": K1_REPLACES}
    k2a = {"name": "sgm_bidir", "route": "cuda", "source": K2_SOURCE, "replaces": K2A_REPLACES}
    k2b = {"name": "sgm_dir_acc", "route": "cuda", "source": K2_SOURCE, "replaces": K2B_REPLACES}
    k3 = {"name": "pm_score_rect", "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES}
    if 2 in phases:
        t0 = time.perf_counter()
        entry.update(phase_kernel(card))
        say(card, f"phase 2: {time.perf_counter() - t0:.2f} s")
    if 3 in phases:
        t0 = time.perf_counter()
        phase_fast_test(card)
        say(card, f"phase 3: {time.perf_counter() - t0:.2f} s")
    if 4 in phases:
        t0 = time.perf_counter()
        entry["launches"] = phase_real_size(card)
        say(card, f"phase 4: {time.perf_counter() - t0:.2f} s")
    if 5 in phases:
        t0 = time.perf_counter()
        res_a, res_b = phase_sgm_kernels(card)
        k2a.update(res_a)
        k2b.update(res_b)
        say(card, f"phase 5: {time.perf_counter() - t0:.2f} s")
    if 6 in phases:
        t0 = time.perf_counter()
        k2a["launches"] = phase_dense_fast_test(card)
        say(card, f"phase 6: {time.perf_counter() - t0:.2f} s")
    if 7 in phases:
        t0 = time.perf_counter()
        k2b["launches"] = phase_dense_real_size(card, work)
        say(card, f"phase 7: {time.perf_counter() - t0:.2f} s")
    if 8 in phases:
        t0 = time.perf_counter()
        k3.update(phase_pm_kernel(card))
        say(card, f"phase 8: {time.perf_counter() - t0:.2f} s")
    if 9 in phases:
        t0 = time.perf_counter()
        phase_pm_fast_test(card)
        say(card, f"phase 9: {time.perf_counter() - t0:.2f} s")
    if 10 in phases:
        t0 = time.perf_counter()
        k3["launches"] = phase_pm_real_size(card, work)
        say(card, f"phase 10: {time.perf_counter() - t0:.2f} s")
    if phases != ALL_PHASES:
        print(f"partial run (phases {sorted(phases)}): no result line", flush=True)
        return 3
    print(json.dumps({"kernels": [entry, k2a, k2b, k3]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
