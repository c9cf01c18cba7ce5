"""On-card smoke run of the PyTorch + CUDA port (sfm_mvs_pipeline_tpu_torch).

Needs one CUDA card; exits non-zero without one, and never falls back to
the CPU. Phases, each timed and each fatal on failure:

  1. device + build: builds kernels K1 (the batched 2-NN matcher), K1x
     (its exact mode on the tensor cores), K2a and K2b (SGM) and K3
     (PatchMatch scoring) from sfm_mvs_pipeline_tpu_torch/csrc/, one nvcc
     process per source, started together, and the native C++ host tier
     with g++ beside them; prints the ptxas reports.
  2. K1 against its plain PyTorch version on the card, all 66 unordered
     pairs of 12 shots, each route: (a) fp32 at the SIFT main path's shape
     (8192 features x 128 dims, integers with ties), bit-equal idx /
     best^2 / second^2 and equal ratio-test masks; (b) the same descriptors
     at ORB-like prefix extents (8.7-11.9% of the slots valid); (c) bf16
     +-1 descriptors at 8192 x 256, full extent (the tensor-core rate
     alone), bit-equal; (d) bf16 at ORB-like prefix extents. (b) and (d)
     under the extent contract (bit-equal at every valid query, best^2 =
     BIG at every invalid one, equal ratio-test masks). CUDA-event times of
     kernel and plain version, and each route's share of its bound.
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
     costs in [0, 1], P1 = 0.03, P2 = 0.3: bit-equal outputs (K2b as
     sgm_staged_hwd runs it); K2a also at insel_k2a_shape(), the largest
     volume phase 6 hands it. CUDA-event medians of kernel and plain version (plain,
     kernel, kernel, plain), the bytes each design moves and the TB/s it
     reaches, and the kernels' ptxas -v registers and shared memory.
  6. the dense fast-test: the port's CLI on sample_data/insel with
     --dense --sgm --mesh --colored --stats --artifacts; 3/3 views, dense
     cloud and mesh written with points and faces, K2a launched (insel
     densifies at 360x202, under the staged-SGM gate), the shapes of its
     launches logged, the largest equal to the one phase 5 timed.
  7. the dense real-size run: the 1080p render of phase 4 through the CLI
     with -Pfeature-limit=0 --dense --sgm --mesh --colored --stats; 12/12
     views, K2b launched (one horizontal-pair and two vertical launches a
     pair), dense accuracy against the renderer's geometry (see
     phase_dense_real_size), the dense wall and its per-stage split.
  8. K3 (the rectified PatchMatch scorer, built in phase 1) against its
     plain PyTorch version on the card at the 1080p render's rect shape:
     C = 6 candidate maps of (H, W) = (1080, 1920), r = 3, maxd as
     derive_max_disp gives it for the render, random rectified images and
     an invalid band in in_n; random and smooth candidates; the full form
     and the parity form (both parities): bit-equal costs; CUDA-event
     medians of kernel and plain version in each form.
  9. the dense fast-test with PatchMatch: insel with --dense
     -Pdense-method=patchmatch --mesh --colored --stats --artifacts; 3/3
     views, dense cloud and mesh with points and faces, K3 launched.
 10. the dense real-size run with PatchMatch: phase 7's scene.npz (or, run
     alone, a fresh SfM of the render) through -Presume= with
     -Pdense-method=patchmatch --dense --mesh --colored --stats; 12/12
     views, K3 launched, dense accuracy at PM_DENSE_SHARE_LIMIT, the dense
     wall and its per-stage split.
 11. K1x against its plain PyTorch version at phase 2's shape: (a) integer
     descriptors with ties, ~5% of the slots invalid and scattered, and (b)
     the same in SIFT's non-prefix slot layout (sift_like_valid), each
     under K1's extent contract against the plain version and against K1
     (bit-equal at every valid query); (c) continuous descriptors within
     1e-5 (|q|^2 + |t|^2) of the plain version and SPLIT_REL_TOL of K1 (see
     phase_exact_kernel); CUDA-event medians of K1x, its plain version and
     K1, K1x's share of its bound over valid counts (the capacity's
     beside it), and its ptxas registers and shared memory.
 12. insel through run-scripts/run-orb-unordered-flann.sh's flags (ORB,
     FLANN, --dense --mesh --colored --stats --artifacts), then
     -Prun=pcl-stats on its three clouds as run-pcl-stats.sh does; 3/3
     views, K1 launched once at D = 256, every pcl-stats output non-empty,
     native tier.
 13. the 1080p render with ORB at full image size (-Pfeature-detector=ORB
     -Pfeature-limit=0, capacity 65,536), sparse; 12/12 views, the ORB
     limits (ORB_ATE_LIMIT, ORB_ROT_LIMIT_DEG), median reprojection < 1 px,
     K1 launched once at (12, 65536, 256); then K1 alone on the run's
     descriptors (bf16, as the SfM passes them), held to its plain version
     under the extent contract and timed against its extent bound; then the
     SfM with five more seeds on the run's features, each 12/12 within the
     ATE and rotation limits.
 14. -Pmatch-precision=exact on the 1080p render; phase 4's limits, K1x
     launched once and K1 not at all; on the run's SIFT descriptors K1x
     against its plain version within 1e-5 (|q|^2 + |t|^2) and against K1
     within the bf16 split's error bound, and the exact and fast (idx, mask)
     tables equal wherever that tolerance decides them; then K1x alone on
     them at (12, 2048, 128), timed against its bound, each shot's valid
     count, extent and occupied 64-slot tiles logged, the inputs saved for
     --k1x-timing.

 15. the multi-device paths on torch.distributed, both ranks on card 0
     (the subprocesses are shown card 0 only, on a host of several cards
     too): (b) the 1080p render through the CLI under torchrun at world 2
     (gloo: the ranks share the card) with phase 7's flags and --artifacts,
     after parallel/dryrun.py at world 2 from an emptied kernel build dir
     (both ranks build every kernel at once); phase 4's
     and 7's limits, the pair-sharded matching, point-sharded BA and
     view-sharded depth-map branches on both ranks, K1 and K2b launched on
     each, only rank 0 writing, and the depth maps bit-equal to a world-1
     run resumed from the run's scene.npz; (c) the same scene at world 2
     with -Pdense-method=patchmatch: K3 on each rank, phase 10's limit,
     depth maps bit-equal to world 1; (a) in a one-rank nccl group
     (SHARDED_FUNCS), match_pairs_sharded (fast and exact), run_bundle_adjustment_sharded
     and compute_depth_maps_sharded (rect --sgm and PatchMatch) on that
     scene, each bit-equal to the one-rank function on the same inputs.
     Each rank's walls, stage split and time in collectives are printed
     beside phases 4, 7 and 10's world-1 walls; two ranks on one card are
     not expected to be faster.
 16. the multi-device paths on four cards, one rank a card, nccl chosen
     by the backend rule (each rank logs its card's index and UUID; four
     distinct cards are checked), through torchrun, with each rank's
     stage split, collectives and kernel launches printed: I-1
     parallel/dryrun.py from an emptied kernel build dir (four ranks build
     every source at once; K1, K1x, K2a, K3 on every rank); I-2 the 1080p
     render with phase 7's flags and --artifacts (K1 pair-sharded, BA
     point-sharded where a run crosses the gate, K2b); I-2b
     run_bundle_adjustment_sharded at world 4 on I-2's scene, float64
     within tests/test_torch_parallel.py's world-4 tolerance of
     run_bundle_adjustment (float32 printed); I-3 PatchMatch resumed from
     I-2's scene.npz (K3); I-4 -Pmatch-precision=exact (K1x); I-5 ORB at
     -Pfeature-limit=0 (K1's bf16 route; rank 0 writes the 805 MB
     scene.npz); I-6 insel with phase 6's flags (3 views and 3 pairs for 4
     ranks: matching unsharded, rank 3 computes no view, K2a). The limits
     of phases 3, 4, 6, 7, 10, 13 and 14; only rank 0 wrote, and in the
     dense runs only rank 0 fused, meshed and textured (ranks 1-3 stop
     after the depth-map gather); the depth maps of I-2, I-3 and I-6
     bit-equal to, and their pointcloud_dense.ply and mesh_dense.ply
     identical to, a world-1 run in this process on card 0 resumed from
     the same scene.npz. Runs by default only on a machine with four
     cards; on fewer, one line says so and `--phases 16` fails.
 17. the mesh of one process (parallel/mesh.py): the CLI with -Pdevice=
     a list of devices, no torchrun. 17a (fewer than four cards, so in the
     default run on one card): two shards on card 0
     (-Pdevice=cuda:0,cuda:0), after an untimed warm-up of the mesh (the
     dryrun and insel's SfM over it): the 1080p render with phase 7's flags (K1
     pair-sharded, K2b view-sharded; BA on card 0, as a one-process mesh
     never shards it), then PatchMatch resumed
     from its scene.npz (K3), each with phase 7's and 10's limits, its
     depth maps bit-equal to, and its pointcloud_dense.ply and
     mesh_dense.ply identical to, its world-1 twin on card 0 (the same
     flags from the same input, or resumed from the mesh run's scene.npz
     where the scenes differ; where phase 7 ran in the same
     call, its wall stands for the --sgm twin's and only the resumed
     reference runs); then on that scene the
     sharded matcher (fast and exact) bit-equal to match_pairs_batch and
     sharded BA (float64) within rel 1e-9 of run_bundle_adjustment, two
     runs bit-identical. 17b (four cards; `--phases 17` on a four-card
     machine): the same over the four cards (-Pdevice=cuda), then a
     resumed --sgm run under -Pprofile= (each card's kernels on one time
     axis), exact (K1x), ORB at -Pfeature-limit=8192 (K1's bf16 route;
     scene.npz stays small) and insel --sgm (K2a; 3 views for 4 cards,
     card 3 computes none), each wall beside phase 16's torchrun wall and
     its world-1 twin's. A mesh run's stage split is each stage's longest
     shard thread (utils/stage_timer.py). Every count is zeroed just before a run and read
     just after; each card's launches of each kernel are printed, and each
     kernel of a run must have launched on every card with work.
Phases 7, 10, 13, 14, 15, 16 and 17 share one render in a temporary work
dir. Every in-process run that names no devices takes card 0 alone
(-Pdevice=cuda:0): the CLI's default, every visible card, would shard.
Prints the card's name and power limit, one JSON line with the kernel
table, and as its last line {"ok": true, "device": {...}}. A run of some
phases only prints no result line; it exits 0 when they pass.

Usage: python3 chip_smoke.py [--phases 1,2,...,17]
       python3 chip_smoke.py --k1x-timing ROOT [--k1x-inputs NPZ]
The second form only times K1x of the checkout at ROOT (k1x_timing), so two
checkouts compare in one call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
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
K1X_SOURCE = "sfm_mvs_pipeline_tpu_torch/csrc/match_exact_kernel.cu"
K1X_REPLACES = "sfm_mvs_pipeline_tpu/ops/pallas/match_kernel.py:88"
ALL_PHASES = set(range(1, 16)) | {17}  # a full run holds them all
FOUR_CARD_PHASE = 16  # in the default run only on a machine with four cards
MESH_PHASE = 17  # 17a on a machine with fewer than four cards, else 17b
# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"fp32": 67e12, "bf16": 989e12}
ONE_CARD = "cuda:0"  # the device of every run that does not name its own
SIFT_ATE_LIMIT = 0.001  # phase 4's, on the 1080p render (PERF.md §2)
DENSE_PARTS = ["load + undistort", "rect sweep", "sweep", "patchmatch", "sgm", "consensus",
               "fusion", "mesh", "refine", "texture"]


def card_lines() -> list[str]:
    """Each card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


def say(card: str, msg: str) -> None:
    """Print a result line, and append it to chiprun_out/chip_smoke.log:
    a long run's output can outgrow what comes back of it."""
    line = f"[{card}] {msg}"
    print(line, flush=True)
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, "chip_smoke.log"), "a") as f:
        f.write(line + "\n")


def run_cli(argv: list[str], log_name: str) -> tuple[int, str, float]:
    """Run the port's CLI in-process; returns (rc, log text, wall s). The
    wall ends with a synchronise of every card. The run takes card 0 alone
    (-Pdevice=cuda:0) unless argv names its devices: on a machine of
    several cards the CLI's default mesh would shard over all of them."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.cli.app import main

    if not any(a.startswith("-Pdevice=") for a in argv):
        argv = [*argv, f"-Pdevice={ONE_CARD}"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
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


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def match_bound(ext, pairs: np.ndarray, F: int, D: int, kind: str, terms: int = 1,
                op_bytes: int = 4) -> dict:
    """Bound of a 2-NN over the pair table `pairs` of shots with valid
    extents `ext` (S,) and capacity F: `terms` products of
    2 ext_q ext_t D flops a pair; bytes of the descriptors' rows up to each
    extent (op_bytes each value), the validity and pair table in, and three
    (P, F) outputs. A kernel that sweeps the whole capacity passes ext = F."""
    ext = np.asarray(ext, np.float64)
    P = len(pairs)
    nbytes = ext.sum() * D * op_bytes + len(ext) * F + P * 8 + 3 * P * F * 4
    flops = terms * 2.0 * D * float((ext[pairs[:, 0]] * ext[pairs[:, 1]]).sum())
    return bound(nbytes, flops, kind)


def int_descriptors_with_ties(S: int, F: int, D: int, seed: int = 0):
    """Integer descriptors in 0..255 (exact in fp32 sums) with duplicated
    target rows, so distances tie exactly, and ~5% invalid slots."""
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 256, size=(S, F, D)).astype(np.float32)
    for s in range(S):
        src = rng.integers(0, F, size=F // 16)
        dst = rng.integers(0, F, size=F // 16)
        desc[s, dst] = desc[s, src]
    return desc, rng.random((S, F)) > 0.05


def pm1_descriptors_with_ties(S: int, F: int, D: int, seed: int = 0) -> np.ndarray:
    """+-1 descriptors (ORB's expansion): one random table with ~6% of its
    signs flipped in each shot, so the ratio test keeps matches, and
    duplicated rows, so distances tie exactly."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2, size=(F, D), dtype=np.int8) * 2 - 1
    desc = np.empty((S, F, D), np.float32)
    for s in range(S):
        desc[s] = base * np.where(rng.random((F, D)) < 0.06, -1, 1)
        desc[s, rng.integers(0, F, size=F // 16)] = desc[s, rng.integers(0, F, size=F // 16)]
    return desc


def orb_like_valid(S: int, F: int, seed: int = 0) -> np.ndarray:
    """ORB's slot layout at -Pfeature-limit=0: the detections first (top-k
    by response), 8.7-11.9% of the capacity (5.7-7.8 k of 65,536 on the
    1080p render)."""
    ext = np.random.default_rng(seed).integers(int(0.087 * F), int(0.119 * F) + 1, size=S)
    return np.arange(F)[None] < ext[:, None]


def k1_extent_contract(out_k, out_p, v_t, p_t, name: str) -> None:
    """K1's contract against its plain version (K1x's too): idx, best^2 and
    second^2 bit-equal at every valid query, best^2 = BIG at every invalid
    one, and the ratio-test masks equal everywhere."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.ops.matching import BIG, ratio_test_mask

    vq = v_t[p_t[:, 0].long()]
    for what, a, b in zip(("idx", "best^2", "second^2"), out_k, out_p):
        if not torch.equal(a[vq], b[vq]):
            raise AssertionError(f"{name}: {what} differs from the reference at "
                                 f"{int((a != b)[vq].sum())} valid queries")
    if not bool((out_k[1][~vq] == BIG).all()):
        raise AssertionError(f"{name}: best^2 is not BIG at every invalid query")
    if not torch.equal(ratio_test_mask(out_k[1], out_k[2], vq),
                       ratio_test_mask(out_p[1], out_p[2], vq)):
        raise AssertionError(f"{name}: ratio-test masks differ from the reference")


def phase_kernel(card: str) -> dict:
    """K1's routes against the plain version at 12 shots, all 66 pairs
    (see the module docstring, phase 2). Returns the fp32 full-extent
    numbers, with every route's under "routes"."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch

    S, F = 12, 8192
    pairs = all_pairs(S)
    P = len(pairs)
    dev = torch.device("cuda")
    p_t = torch.from_numpy(pairs).to(dev)
    routes = {}

    def run(name: str, desc: np.ndarray, valid: np.ndarray, dtype, full: bool) -> None:
        d32 = torch.from_numpy(desc).to(dev)
        d_t = d32.to(dtype)
        v_t = torch.from_numpy(valid).to(dev)

        def kern():
            return K.two_nn_batch_fused(d_t, v_t, p_t)

        def plain():
            return two_nn_batch(d32, v_t, p_t)

        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        if full:  # every block is swept: all three outputs bit-equal everywhere
            for what, a, b in zip(("idx", "best^2", "second^2"), out_k, out_p):
                if not torch.equal(a, b):
                    raise AssertionError(f"K1 {name}: {what} differs from the plain version at "
                                         f"{int((a != b).sum())} entries")
        k1_extent_contract(out_k, out_p, v_t, p_t, f"K1 {name}")
        vq = v_t[p_t[:, 0].long()]
        err = float(torch.maximum((out_k[1] - out_p[1])[vq].abs().max(),
                                  (out_k[2] - out_p[2])[vq].abs().max()))
        n_ties = int((out_p[1] == out_p[2])[vq].sum())
        del out_k, out_p
        # alternate plain / kernel so neither gets a warmer card
        ms_p1 = timed(plain, reps=3)
        ms_k1 = timed(kern)
        ms_k2 = timed(kern)
        ms_p2 = timed(plain, reps=3)
        ms_k = float(np.median([ms_k1, ms_k2]))
        ms_p = float(np.median([ms_p1, ms_p2]))
        ext = K.valid_extent(v_t).cpu().numpy()
        D = desc.shape[-1]
        kind, op_bytes = ("bf16", 2) if dtype == torch.bfloat16 else ("fp32", 4)
        b = match_bound(ext, pairs, F, D, kind, op_bytes=op_bytes)
        tflop = 2.0 * D * float((ext[pairs[:, 0]] * ext[pairs[:, 1]]).sum()) / 1e12
        say(card, f"K1 {name} at S={S} F={F} D={D} P={P}, extents {int(ext.min())}-"
                  f"{int(ext.max())}: {'bit-equal' if full else 'extent contract holds'} "
                  f"(max abs err {err} at valid queries, {n_ties} tied best/second); K1 "
                  f"{ms_k1:.3f}/{ms_k2:.3f} ms (median of 5), plain {ms_p1:.3f}/{ms_p2:.3f} ms "
                  f"(median of 3); {tflop / ms_k * 1e3:.1f} {kind} TFLOP/s, "
                  f"{b['bound_ms'] / ms_k:.2%} of its {b['bound_ms']:.3f} ms bound "
                  f"({b['bound_by']}; {card})")
        routes[name] = {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p, **b}

    desc, valid = int_descriptors_with_ties(S, F, 128)
    run("fp32", desc, valid, torch.float32, True)
    run("fp32_prefix", desc, orb_like_valid(S, F, seed=1), torch.float32, False)
    desc = pm1_descriptors_with_ties(S, F, 256, seed=2)
    valid = np.random.default_rng(3).random((S, F)) > 0.05
    valid[:, -1] = True  # full extent
    run("bf16", desc, valid, torch.bfloat16, True)
    run("bf16_prefix", desc, orb_like_valid(S, F, seed=4), torch.bfloat16, False)
    return {**routes["fp32"], "routes": routes}


# K1x against K1 (or any exact dot product): the bf16 split leaves each
# operand's remainder after hi + lo (<= 2^-16 relative) and drops
# q2_lo.t_lo (<= 2^-16 |q2_i t_i|), three terms of <= 2^-16 |q2_i t_i| a
# product, so |d dot| <= 3 2^-16 |q2| |t| <= 3 2^-16 (|q|^2 + |t|^2) =
# 4.58e-5 of it, and 5e-5 covers the fp32 sums on top.
SPLIT_REL_TOL = 5e-5


def exact_agreement(out_x, out_r, d_t, v_t, p_t, name: str, rel_tol: float = 1e-5) -> dict:
    """Hold K1x's (idx, best^2, second^2) against another 2-NN of the same
    float descriptors at every valid query (K1x sweeps only valid slots and
    leaves BIG at invalid ones): |best^2 - ref| <= rel_tol (|q|^2 +
    |t_best|^2) and |second^2 - ref| <= rel_tol (|q|^2 + max |t|^2 of the
    target shot). Against its plain version rel_tol is 1e-5: the split's
    products are exact in fp32 on both sides and only the order and rounding
    of the fp32 sums differ. Against K1 it is SPLIT_REL_TOL. idx must be
    equal wherever the reference's best and second lie farther apart than
    the tolerance, and ratio-test masks equal except within it of the 0.49
    boundary. Returns the largest differences, the counts, and `loose`, the
    (P, F) entries where the two match tables may differ."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.ops.matching import BIG, ratio_test_mask

    ix, bx, sx = out_x
    ir, br, sr = out_r
    n = (d_t * d_t).sum(-1)  # (S, F)
    pq, pt = p_t[:, 0].long(), p_t[:, 1].long()
    vq = v_t[pq]
    qn = n[pq]
    tol_b = rel_tol * (qn + torch.gather(n[pt], 1, ir.long()))
    tol_s = rel_tol * (qn + n[pt].amax(dim=1, keepdim=True))
    db = torch.where(vq, (bx - br).abs(), torch.zeros_like(bx))
    ds = torch.where(vq, (sx - sr).abs(), torch.zeros_like(sx))
    if bool((db > tol_b).any()) or bool((ds > tol_s).any()):
        raise AssertionError(f"K1x distances off {name}'s beyond {rel_tol} (|q|^2 + |t|^2): max "
                             f"|d best| {float(db.max())}, max |d second| {float(ds.max())}")
    if not bool((bx[~vq] == BIG).all()):
        raise AssertionError("K1x best^2 is not BIG at every invalid query")
    apart = vq & ((sr - br) > tol_b + tol_s)
    if not torch.equal(ix[apart], ir[apart]):
        raise AssertionError(f"K1x idx differs from {name}'s at "
                             f"{int((ix != ir)[apart].sum())} separated entries")
    mx, mr = ratio_test_mask(bx, sx, vq), ratio_test_mask(br, sr, vq)
    near = (br - 0.49 * sr).abs() <= tol_b + 0.49 * tol_s
    if not torch.equal(mx[~near], mr[~near]):
        raise AssertionError(f"K1x ratio-test masks differ from {name}'s away from the 0.49 "
                             f"boundary")
    return {"max_abs_err": float(torch.maximum(db.max(), ds.max())),
            "rel": float(torch.maximum((db / tol_b).max(), (ds / tol_s).max())) * rel_tol,
            "apart": int(apart.sum()), "valid": int(vq.sum()), "flips": int((mx != mr).sum()),
            "near": int(near.sum()), "loose": near | (vq & ~apart)}


def sift_like_valid(S: int, F: int, seed: int = 0) -> np.ndarray:
    """SIFT's slot layout while 2 k_sel <= F (ops/sift.py: primaries, then
    secondary orientations from k_sel): a prefix of 55-75% of k_sel = F / 2
    slots, then ~15% of the same offsets from k_sel. Not a valid prefix: the
    valid extent is ~k_sel + the prefix, the valid count ~1.15 x the prefix
    (phase 14's render: 716-858 valid of 2048, k_sel 1024)."""
    rng = np.random.default_rng(seed)
    k, k_sel = np.arange(F)[None], F // 2
    n = rng.integers(int(0.55 * k_sel), int(0.75 * k_sel), size=(S, 1))
    return (k < n) | ((k >= k_sel) & (k - k_sel < n) & (rng.random((S, F)) < 0.15))


def k1x_phase11_inputs(S: int = 12, F: int = 8192, D: int = 128) -> dict:
    """Phase 11's K1x inputs, name -> (descriptors, valid) in numpy: "int",
    integer descriptors with ties and ~5% invalid slots; "sift", integer
    descriptors with ties in sift_like_valid's layout; "cont", continuous
    descriptors (|N(0,1)| plus per-shot noise, so distances do not cancel
    against the norms) with "int"'s validity. Seeds 1 and 2 make "int" and
    "cont" as every version of this phase has made them, so "cont" times
    compare across checkouts."""
    desc, valid = int_descriptors_with_ties(S, F, D, seed=1)
    rng = np.random.default_rng(2)
    base = np.abs(rng.normal(size=(F, D))).astype(np.float32)
    cont = np.abs(np.stack([base + rng.normal(size=(F, D)).astype(np.float32) * (0.1 + 0.03 * s)
                            for s in range(S)])).astype(np.float32)
    return {"int": (desc, valid), "sift": (int_descriptors_with_ties(S, F, D, seed=3)[0],
                                           sift_like_valid(S, F, seed=4)),
            "cont": (cont, valid)}


def k1x_bounds(valid: np.ndarray, pairs: np.ndarray, D: int) -> tuple[dict, dict]:
    """K1x's bound over the shots' valid counts (what it sweeps) and over
    the padded capacity: 3 bf16 products of 2 count_q count_t D flops a
    pair, the float32 descriptor rows read once, three (P, F) outputs."""
    S, F = valid.shape
    return (match_bound(valid.sum(axis=1), pairs, F, D, "bf16", terms=3),
            match_bound(np.full(S, F), pairs, F, D, "bf16", terms=3))


def all_pairs(S: int) -> np.ndarray:
    return np.array([(a, b) for a in range(S) for b in range(a + 1, S)], np.int32)


def phase_exact_kernel(card: str) -> dict:
    """K1x against its plain version (and K1) at 12 x 8192 x 128 over all
    66 pairs, on k1x_phase11_inputs(). "int" and "sift": K1's extent
    contract against the plain version and against K1 (bit-equal at every
    valid query). "cont": within exact_agreement's tolerance of the plain
    version and within SPLIT_REL_TOL of K1. Times on "cont" and "sift",
    bounds over valid counts and capacity, ptxas report."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch, two_nn_exact

    S, F, D = 12, 8192, 128
    pairs = all_pairs(S)
    P = len(pairs)
    dev = torch.device("cuda")
    p_t = torch.from_numpy(pairs).to(dev)
    inputs = k1x_phase11_inputs(S, F, D)
    for name, instance in (("2-NN", "two_nn_exact_kernel"), ("operand prep", "exact_prep_kernel")):
        say(card, f"K1x, {name}: {ptxas_report(K.EXACT_SOURCE, instance)}")
    say(card, f"K1x: {K.exact_smem(D)} B dynamic smem a block at D={D}, {K.exact_smem(256)} B "
              f"at D=256 (288 threads)")

    for name in ("int", "sift"):
        desc, valid = inputs[name]
        d_t, v_t = torch.from_numpy(desc).to(dev), torch.from_numpy(valid).to(dev)
        out_x = K.two_nn_exact_batch(d_t, v_t, p_t)
        out_p = two_nn_batch(d_t, v_t, p_t, nn=two_nn_exact)
        out_1 = K.two_nn_batch_fused(d_t, v_t, p_t)
        torch.cuda.synchronize()
        k1_extent_contract(out_x, out_p, v_t, p_t, f"K1x {name} vs its plain version")
        k1_extent_contract(out_x, out_1, v_t, p_t, f"K1x {name} vs K1")
        vq = v_t[p_t[:, 0].long()]
        n_ties = int((out_p[1] == out_p[2])[vq].sum())
        cnt = valid.sum(axis=1)
        say(card, f"K1x {name}: extent contract holds against its plain version and K1 on integer "
                  f"descriptors at S={S} F={F} D={D} P={P}, valid counts {int(cnt.min())}-"
                  f"{int(cnt.max())}, extents {int(K.valid_extent(v_t).min())}-"
                  f"{int(K.valid_extent(v_t).max())} ({n_ties} tied best/second at valid queries)")
        del out_x, out_p, out_1

    desc, valid = inputs["cont"]
    d_t, v_t = torch.from_numpy(desc).to(dev), torch.from_numpy(valid).to(dev)
    out_x = K.two_nn_exact_batch(d_t, v_t, p_t)
    agree = exact_agreement(out_x, two_nn_batch(d_t, v_t, p_t, nn=two_nn_exact), d_t, v_t, p_t,
                            "its plain version")
    k1 = exact_agreement(out_x, K.two_nn_batch_fused(d_t, v_t, p_t), d_t, v_t, p_t, "K1",
                         SPLIT_REL_TOL)
    err = agree["max_abs_err"]
    say(card, f"K1x on continuous descriptors: max |d| {err} ({agree['rel']:.3e} of |q|^2 + "
              f"|t|^2), idx equal at {agree['apart']} separated entries of {agree['valid']}, "
              f"{agree['flips']} mask flips within tolerance of 0.49 ({agree['near']} near); vs K1 "
              f"max |d| {k1['max_abs_err']} ({k1['rel']:.3e})")
    del out_x

    def kern():
        return K.two_nn_exact_batch(d_t, v_t, p_t)

    def plain():
        return two_nn_batch(d_t, v_t, p_t, nn=two_nn_exact)

    def k1():
        return K.two_nn_batch_fused(d_t, v_t, p_t)

    ms_p1 = timed(plain, reps=3)
    ms_x1 = timed(kern)
    ms_1 = timed(k1)
    ms_x2 = timed(kern)
    ms_p2 = timed(plain, reps=3)
    ms_x = float(np.median([ms_x1, ms_x2]))
    ms_p = float(np.median([ms_p1, ms_p2]))
    b, b_cap = k1x_bounds(valid, pairs, D)
    cnt = valid.sum(axis=1).astype(np.float64)
    tflop = 3 * 2.0 * D * float((cnt[pairs[:, 0]] * cnt[pairs[:, 1]]).sum()) / 1e12
    say(card, f"K1x cont {ms_x1:.3f}/{ms_x2:.3f} ms (median of 5), plain {ms_p1:.3f}/{ms_p2:.3f} "
              f"ms (median of 3), K1 {ms_1:.3f} ms on the same inputs; K1x {tflop / ms_x * 1e3:.1f} "
              f"bf16 TFLOP/s over valid counts, {b['bound_ms'] / ms_x:.2%} of its "
              f"{b['bound_ms']:.3f} ms bound over valid counts ({b['bound_by']}; capacity bound "
              f"{b_cap['bound_ms']:.3f} ms; {card})")

    desc, valid = inputs["sift"]
    d_t, v_t = torch.from_numpy(desc).to(dev), torch.from_numpy(valid).to(dev)
    ms_s = [timed(kern), timed(kern)]
    b_s, _ = k1x_bounds(valid, pairs, D)
    say(card, f"K1x sift {ms_s[0]:.3f}/{ms_s[1]:.3f} ms (median of 5), "
              f"{b_s['bound_ms'] / float(np.median(ms_s)):.2%} of its {b_s['bound_ms']:.3f} ms "
              f"bound over valid counts ({b_s['bound_by']}; {card})")
    return {"max_abs_err": err, "ms": ms_x, "plain_ms": ms_p, **b,
            "capacity_bound_ms": b_cap["bound_ms"], "k1_ms": ms_1, "sift_ms": float(np.median(ms_s)),
            "sift_bound_ms": b_s["bound_ms"]}


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
        WORLD1_WALLS.update({"phase 4 cold": walls[0], "phase 4 warm": walls[1]})
    return launches


def ptxas_report(source: str, instance: str) -> str:
    """Registers, spills and static shared memory that `ptxas -v` gave (in
    phase 1's build) for the kernel whose mangled name holds `instance`."""
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import build

    for block in build.REPORTS.get(source, "").split("Compiling entry function")[1:]:
        if instance in block.split("\n", 1)[0]:
            regs = re.search(r"Used (\d+) registers", block)
            smem = re.search(r"(\d+) bytes smem", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            return (f"{regs.group(1) if regs else '?'} registers, "
                    f"{smem.group(1) if smem else 0} B static smem, "
                    f"{spill.group(1) if spill else '?'} B spill stores")
    return "no ptxas report"


def insel_k2a_shape() -> tuple[int, int, int]:
    """(H, W, D) of the largest volume that phase 6's insel run hands K2a:
    the rect engine scans the images at their size (under the ladder's
    max_resolution) with MVSConfig's n_planes levels; phase 6 checks it."""
    import cv2

    from sfm_mvs_pipeline_tpu_torch.mvs.pipeline import MVSConfig

    insel = os.path.join(ROOT, "sample_data", "insel")
    h, w = max(cv2.imread(os.path.join(insel, f)).shape[:2] for f in sorted(os.listdir(insel)))
    return h, w, MVSConfig().n_planes


def phase_sgm_kernels(card: str) -> tuple[dict, dict]:
    """K2a and K2b against their plain versions at the 1080p rect volume.
    K2a is timed as sgm_aggregate calls it (both axes), at (1080, 1920, 96)
    and at insel_k2a_shape(); K2b as sgm_staged_hwd calls it (the
    horizontal pair with its bf16 rounding, then the two vertical
    directions). Tolerance 0: both kernels keep the plain order of every
    min, add and subtract, and reorder sums only as a + b == b + a and
    0 + x == x allow. Times: plain, kernel, kernel, plain in one call; the
    bytes each design moves and the rate it reaches; registers from ptxas
    -v."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.mvs.sgm import (sgm_bidir_plain, sgm_dir_acc_plain,
                                                     sgm_hpair_plain, staged_sum)
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    p1, p2 = 0.03, 0.3
    gen = torch.Generator(device="cuda").manual_seed(0)

    def held(name, kern, plain):
        """Bit-equality, then plain / kernel / kernel / plain medians."""
        outs_k, outs_p = kern(), plain()
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
        ms_k1 = timed(kern, reps=5)
        ms_k2 = timed(kern, reps=5)
        ms_p2 = timed(plain, reps=3)
        return {"max_abs_err": err, "ms": float(np.median([ms_k1, ms_k2])),
                "plain_ms": float(np.median([ms_p1, ms_p2])), "ms_runs": [ms_k1, ms_k2],
                "plain_runs": [ms_p1, ms_p2]}

    def report(name, shape, r, passes, vol):
        gb = passes * vol / 1e9
        say(card, f"{name} bit-equal to plain at (H, W, D) = {shape}, P1 {p1} P2 {p2} (max abs "
                  f"err {r['max_abs_err']}); kernel {r['ms_runs'][0]:.3f}/{r['ms_runs'][1]:.3f} "
                  f"ms (median of 5), plain {r['plain_runs'][0]:.3f}/{r['plain_runs'][1]:.3f} "
                  f"ms (median of 3); design moves {gb:.3f} GB ({passes} volume passes), "
                  f"{gb / r['ms']:.3f} TB/s ({card})")

    H, W, D = 1080, 1920, 96
    cost = torch.rand((H, W, D), generator=gen, device="cuda", dtype=torch.float32)
    vol = H * W * D * 4.0
    ra = held("K2a", lambda: [K2.sgm_bidir(cost, p1, p2, axis=a) for a in (1, 0)],
              lambda: [sgm_bidir_plain(cost, p1, p2, a) for a in (1, 0)])
    report("K2a, both axes,", (H, W, D), ra, 10, vol)
    rb = held("K2b", lambda: [K2.sgm_staged_hwd(cost, p1, p2)],
              lambda: [staged_sum(cost, p1, p2, sgm_hpair_plain, sgm_dir_acc_plain)])
    report("K2b, four directions with the bf16 rounding,", (H, W, D), rb, 10.5, vol)
    # K2a reads the f32 volume once and writes one per axis; the staged
    # route reads it once and writes the sum. Both are bound by bytes: ~8
    # FP32 operations an element and direction.
    ra.update(bound(4 * vol, 4 * 8.0 * H * W * D, "fp32"))
    rb.update(bound(2 * vol, 4 * 8.0 * H * W * D, "fp32"))
    del cost

    H, W, D = insel_k2a_shape()
    cost = torch.rand((H, W, D), generator=gen, device="cuda", dtype=torch.float32)
    vol = H * W * D * 4.0
    ri = held("K2a at insel's shape", lambda: [K2.sgm_bidir(cost, p1, p2, axis=a) for a in (1, 0)],
              lambda: [sgm_bidir_plain(cost, p1, p2, a) for a in (1, 0)])
    report("K2a, both axes, at insel's largest launch shape", (H, W, D), ri, 10, vol)
    ri.update(bound(4 * vol, 4 * 8.0 * H * W * D, "fp32"), shape=[H, W, D])
    ra["insel"] = {k: ri[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}

    for name, instance, r in (("K2a", "sgm_pair_kernelILi3ELb0E", ra),
                              ("K2b horizontal pair", "sgm_pair_kernelILi3ELb1E", rb),
                              ("K2b sgm_dir_acc", "sgm_dir_acc_kernelILi3E", rb)):
        ptx = ptxas_report(K2_SOURCE.rsplit("/", 1)[1], instance)
        say(card, f"{name} at D = 96 (NV = 3): ptxas -v {ptx}")
        r.setdefault("ptxas", {})[name] = ptx
    return ra, rb


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
    """insel through the dense CLI with --sgm (K2a). Logs the (H, W, D, axis)
    of every K2a launch and checks that the largest is insel_k2a_shape(),
    the shape phase 5 times."""
    from sfm_mvs_pipeline_tpu_torch.mvs import sgm as S
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    aggregate = S.sgm_aggregate
    shapes = []

    def recorded(cost_volume, p1=0.03, p2=0.3):  # its callers look it up at each call
        d, h, w = cost_volume.shape
        shapes.extend([(h, w, d, 1), (h, w, d, 0)])  # K2a along W, then along H
        return aggregate(cost_volume, p1, p2)

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out-dense-fast-test")
        argv = ["-Prun=photogrammetrie", f"-Pimage={os.path.join(ROOT, 'sample_data', 'insel')}",
                f"-Pout={out}", "--dense", "--sgm", "--mesh", "--colored", "--stats", "--artifacts"]
        K2.sgm_bidir.launches = 0
        S.sgm_aggregate = recorded
        try:
            rc, log, wall = run_cli(argv, "chip_smoke_dense_fast_test.log")
        finally:
            S.sgm_aggregate = aggregate
        launches = K2.sgm_bidir.launches
        if rc != 0:
            raise AssertionError(f"dense fast-test CLI exited {rc}")
        scene, med = check_outputs(out)
        n_rec = int(scene.recovered.sum())
        n_pts, _ = ply_counts(os.path.join(out, "pointcloud_dense.ply"))
        n_vm, n_faces = ply_counts(os.path.join(out, "mesh_dense.ply"))
        depth_files = sorted(f for f in os.listdir(out) if f.startswith("depth_"))
        counts = {sh: shapes.count(sh) for sh in sorted(set(shapes))}
        say(card, f"dense fast-test: rc 0, {n_rec}/{scene.n_shots} views, {n_pts} dense points, "
                  f"mesh {n_vm} vertices {n_faces} faces, {len(depth_files)} depth maps, "
                  f"K2a launches {launches} at (H, W, D, axis) "
                  + ", ".join(f"{sh} x{n}" for sh, n in counts.items()) + f", wall {wall:.2f} s")
        if n_rec != 3 or scene.n_shots != 3:
            raise AssertionError(f"dense fast-test recovered {n_rec}/3 views")
        if n_pts <= 0 or n_faces <= 0:
            raise AssertionError(f"dense fast-test: {n_pts} dense points, {n_faces} faces")
        if not os.path.exists(os.path.join(out, "mesh_dense.png")) or len(depth_files) != 3:
            raise AssertionError("dense fast-test: texture atlas or depth maps missing")
        if launches <= 0 or launches != len(shapes):
            raise AssertionError(f"dense fast-test: K2a launches {launches}, {len(shapes)} recorded")
        largest = max(shapes, key=lambda sh: sh[0] * sh[1] * sh[2])[:3]
        if largest != insel_k2a_shape():
            raise AssertionError(f"K2a's largest insel launch {largest} is not phase 5's "
                                 f"{insel_k2a_shape()}")
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


def dense_counts(log: str) -> str:
    """The dense stage's counts from a CLI log: valid pixels of each view's
    depth map, fused points, and mesh faces after each step of
    mvs/mesh.py::mesh_from_depth_maps (back-projection, cluster_vertices,
    remove_small_components, close_holes, smoothing)."""
    # in view order: a mesh's shard threads log their views interleaved
    valid = [n for _, n in sorted((int(v), int(n)) for v, n in re.findall(
        r"\] view (\d+): depth range .*?, (\d+)/\d+ valid px", log))]
    fused = re.findall(r"fused dense cloud: (\d+) points", log)
    steps = ["raw mesh", "clustered", "small components removed", "holes closed", "cleaned"]
    faces = {k: re.findall(re.escape(k) + r": \d+ verts, (\d+) faces", log) for k in steps}
    return (f"valid px per view {valid} (sum {sum(valid)}); fused points "
            f"{fused[-1] if fused else 'none'}; faces " + ", ".join(
                f"{k} {v[-1] if v else 'none'}" for k, v in faces.items()))


def run_dense_cli(card: str, argv: list[str], log_name: str, counters, n_views: int,
                  gt_R, gt_C, out: str, limit: float, label: str) -> list[int]:
    """One dense CLI run of the render under the stage timers, checked:
    all views, points and faces, dense accuracy at `limit`, each kernel
    whose wrapper is in `counters` launched. Returns their launch counts."""
    from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

    for counter in counters:
        counter.launches = 0
    stage_timer.enable()
    try:
        rc, log, wall = run_cli(argv, log_name)
        split = stage_timer.report()
    finally:
        stage_timer.enable(False)
    launches = [counter.launches for counter in counters]
    WORLD1_WALLS[label] = wall
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
              f"mesh {n_vm} vertices {n_faces} faces, launches "
              + ", ".join(f"{c.__name__} {n}" for c, n in zip(counters, launches))
              + f", CLI wall {wall:.2f} s")
    say(card, f"{label} dense stage wall {dense_s:.3f} s (synchronising stage timers): "
              + "; ".join(f"{k} {split[k][0]:.3f} s x{split[k][1]}"
                          for k in DENSE_PARTS if k in split)
              + f"; other {rest:.3f} s")
    say(card, f"{label} counts: " + dense_counts(log))
    if n_rec != n_views:
        raise AssertionError(f"{label} recovered {n_rec}/{n_views} views")
    if n_pts <= 0 or n_faces <= 0:
        raise AssertionError(f"{label}: {n_pts} dense points, {n_faces} faces")
    if not share >= limit:
        raise AssertionError(f"{label}: {share:.4%} of points on the surfaces")
    for counter, n in zip(counters, launches):
        if n <= 0:
            raise AssertionError(f"{label} never launched {counter.__name__}")
    return launches


def phase_dense_real_size(card: str, work: str, n_views=12, h=1080, w=1920, f=1680.0) -> int:
    """The 1080p render through the CLI's dense path (staged SGM, K2b: one
    sgm_hpair and two sgm_dir_acc launches a pair). Returns K2b's launches.

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
    n_h, n_v = run_dense_cli(card, argv, "chip_smoke_dense_real_size.log",
                             (K2.sgm_hpair, K2.sgm_dir_acc), n_views, gt_R, gt_C, out,
                             DENSE_SHARE_LIMIT, "dense real-size")
    if n_v != 2 * n_h:  # the horizontal pair and the two vertical directions of each pair
        raise AssertionError(f"dense real-size: {n_h} horizontal and {n_v} vertical K2b launches")
    return n_h + n_v


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


def k3_bound(C: int, H: int, W: int, r: int, parity) -> dict:
    """Bound of K3: per active (pixel, candidate), (2r+1)^2 window samples
    of 8 FP32 operations (bilinear 3, three sums 5) and ~16 for the
    statistics; bytes: the active candidates in, every cost out, the four
    (H, W) f32 maps and in_n. The parity form has half the active pixels."""
    n_act = H * W if parity is None else (H * W + (1 - parity)) // 2
    k = (2 * r + 1) ** 2
    return bound(C * n_act * 4.0 + C * H * W * 4.0 + 4 * H * W * 4.0 + H * W,
                 C * n_act * (8.0 * k + 16), "fp32")


def phase_pm_kernel(card: str) -> dict:
    """K3 against its plain version at the 1080p render's rect shape, in
    the full form (every pixel: the random init) and the parity form (one
    checkerboard parity: the 16 half-iterations of a pair), with random
    and smooth candidates. Tolerance 0: K3 rounds every multiply, add,
    divide and square root as the plain version's separate torch ops do, in
    the same order. The kernel's time includes the wrapper's zeroing of the
    neighbour's invalid pixels. Returns the full form's random-candidate
    numbers, with both forms' under "forms"."""
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
    res = {"full": {}, "parity": {}}
    for name, cands in (("random", cands_rand), ("smooth", cands_smooth)):
        for form, parities in (("full", (None,)), ("parity", (0, 1))):
            for parity in parities:
                def kern():
                    return K3.pm_score_rect(cands, *args, maxd=maxd, window_radius=r,
                                            parity=parity)

                def plain():
                    return pm_score_rect_plain(cands, *args, maxd=maxd, window_radius=r,
                                               parity=parity)

                ok, op = kern(), plain()
                torch.cuda.synchronize()
                if not bool(torch.isfinite(ok).all()):
                    raise AssertionError(f"K3 ({form}, {name}) output has non-finite values")
                err = float((ok - op).abs().max())
                if not torch.equal(ok, op):
                    raise AssertionError(f"K3 ({form}, parity {parity}, {name}) differs from its "
                                         f"plain version at {int((ok != op).sum())} entries "
                                         f"(max abs err {err})")
                n_one = int((ok == 1).sum())
                del ok, op
            # timed at the last parity checked
            ms_p1 = timed(plain, reps=3)
            ms_k1 = timed(kern, reps=5)
            ms_k2 = timed(kern, reps=5)
            ms_p2 = timed(plain, reps=3)
            ms_k = float(np.median([ms_k1, ms_k2]))
            ms_p = float(np.median([ms_p1, ms_p2]))
            b = k3_bound(C, H, W, r, parity)
            say(card, f"K3 {form} form bit-equal to plain at C={C} (H, W) = ({H}, {W}) r={r} "
                      f"maxd={maxd} (derive_max_disp, z_min {z_min}), {name} candidates (max abs "
                      f"err {err}, {n_one} costs at 1); kernel {ms_k1:.3f}/{ms_k2:.3f} ms (median "
                      f"of 5), plain {ms_p1:.3f}/{ms_p2:.3f} ms (median of 3); "
                      f"{b['bound_ms'] / ms_k:.2%} of its {b['bound_ms']:.4f} ms bound "
                      f"({b['bound_by']}; {card})")
            res[form][name] = {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p, **b}
    return {**res["full"]["random"], "forms": res}


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
    (launches,) = run_dense_cli(card, argv, "chip_smoke_pm_real_size.log", (K3.pm_score_rect,),
                                n_views, gt_R, gt_C, out, PM_DENSE_SHARE_LIMIT,
                                "PatchMatch real-size")
    say(card, f"PatchMatch real-size: K3 launches {launches} "
              f"({launches / (5 * n_views):.2f} per pair, 5 neighbours per view)")
    return launches


# the flags of run-scripts/run-orb-unordered-flann.sh, images and output aside
ORB_FLANN_FLAGS = ["--forceColoredOutput", "-Ploglevel=2", "-Pcamera-model=SimpleRadial",
                   "-Pfeature-detector=ORB", "-Pfeature-limit=0", "-Pomp-feature-threads=8",
                   "-Pfeature-matcher=FLANN", "--colored", "--dense", "--mesh", "--stats",
                   "--artifacts"]


def phase_orb_flann_insel(card: str) -> int:
    """insel through run-orb-unordered-flann.sh's flags, then -Prun=pcl-stats
    on its three clouds as run-pcl-stats.sh does: 3/3 views, K1 launched on
    the +-1 expansion at D = 256 (FLANN takes the exact kernel), K1x not
    launched, every pcl-stats output written and non-empty, the native host
    tier live, the mesh's quality PLY keeping its faces."""
    from sfm_mvs_pipeline_tpu_torch import native
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "reconstruction")
        argv = ["-Prun=photogrammetrie", f"-Pimage={os.path.join(ROOT, 'sample_data', 'insel')}",
                f"-Pout={out}", *ORB_FLANN_FLAGS]
        K.two_nn_batch_fused.launches = 0
        K.two_nn_exact_batch.launches = 0
        rc, log, wall = run_cli(argv, "chip_smoke_orb_flann_insel.log")
        launches, launches_x = K.two_nn_batch_fused.launches, K.two_nn_exact_batch.launches
        if rc != 0:
            raise AssertionError(f"ORB + FLANN insel CLI exited {rc}")
        scene, med = check_outputs(out)
        n_rec = int(scene.recovered.sum())
        feats = [int(v) for v in scene.feat_valid.sum(axis=1)]
        n_pts, _ = ply_counts(os.path.join(out, "pointcloud_dense.ply"))
        n_vm, n_faces = ply_counts(os.path.join(out, "mesh_dense.ply"))
        say(card, f"ORB + FLANN insel: rc 0, {n_rec}/{scene.n_shots} views, features {feats}, "
                  f"median reprojection {med:.4f} px, {int(scene.point_valid.sum())} sparse "
                  f"points, {n_pts} dense points, mesh {n_vm} vertices {n_faces} faces, K1 "
                  f"launches {launches} on descriptors {scene.descriptors.shape}, K1x launches "
                  f"{launches_x}, wall {wall:.2f} s")
        if n_rec != 3 or scene.n_shots != 3:
            raise AssertionError(f"ORB + FLANN insel recovered {n_rec}/3 views")
        if launches != 1 or launches_x != 0 or scene.descriptors.shape[2] != 256:
            raise AssertionError(f"ORB + FLANN insel: K1 launches {launches}, K1x {launches_x}, "
                                 f"descriptors {scene.descriptors.shape}")

        t0 = time.perf_counter()
        sizes = {}
        for cloud in ("pointcloud_sparse", "pointcloud_dense", "mesh_dense"):
            base = os.path.join(out, cloud)
            rc, _, _ = run_cli(["-Prun=pcl-stats", f"-Pinput={base}.ply",
                                f"-Pstats={base}.stats.csv", f"-Pneighbors={base}.neighbors.csv",
                                f"-Pquality={base}.quality.ply"], f"chip_smoke_pcl_stats_{cloud}.log")
            if rc != 0:
                raise AssertionError(f"pcl-stats on {cloud}.ply exited {rc}")
            for ext in ("stats.csv", "neighbors.csv", "quality.ply"):
                path = f"{base}.{ext}"
                sizes[f"{cloud}.{ext}"] = os.path.getsize(path) if os.path.exists(path) else 0
        _, q_faces = ply_counts(os.path.join(out, "mesh_dense.quality.ply"))
        say(card, f"pcl-stats on the three clouds in {time.perf_counter() - t0:.2f} s "
                  f"(native tier {native.available()}): {sizes}; mesh quality PLY {q_faces} faces")
        empty = [k for k, v in sizes.items() if v <= 0]
        if empty or not native.available() or q_faces != n_faces:
            raise AssertionError(f"pcl-stats: empty {empty}, native {native.available()}, "
                                 f"quality mesh faces {q_faces} of {n_faces}")
    return launches


def trajectory_error(scene, gt_R, gt_C) -> tuple[np.ndarray, float, float]:
    """(recovered shots, sim(3)-aligned ATE as a share of the trajectory
    extent, max relative rotation in degrees) against the render."""
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np
    from sfm_mvs_pipeline_tpu_torch.utils.metrics import trajectory_compare

    rec = np.nonzero(scene.recovered)[0]
    est_R = aa_to_rotmat_np(scene.poses[rec, :3])
    est_C = -np.einsum("sji,sj->si", est_R, scene.poses[rec, 3:])
    cmp = trajectory_compare(est_C, est_R, gt_C[rec], gt_R[rec])
    extent = float(np.linalg.norm(gt_C[rec][-1] - gt_C[rec][0]))
    return rec, cmp["ate_rmse"] / extent, float(cmp["max_rel_rot_deg"])


# Limits of phase 13, from the JAX package's ORB CLI on the CPU on this
# render cut to 480x270 (f = 420): 12/12 views, ATE 0.096% of extent, max
# relative rotation 0.41 deg, median reprojection 0.37 px. The ATE and
# rotation limits leave ~5x and ~3.6x room for f32 against f64 and the
# port's RANSAC draws, as phase 7's limit was set; the reprojection limit is
# the 1 px of every phase.
ORB_ATE_LIMIT = 0.005
ORB_ROT_LIMIT_DEG = 1.5
# SfM seeds phase 13 reruns on the CLI run's features (the CLI's is 0)
ORB_SWEEP_SEEDS = (1, 2, 3, 4, 5)


def sparse_real_size_run(card: str, argv: list[str], log_name: str, n_views: int,
                         gt_R, gt_C, ate_limit: float, rot_limit: float, label: str):
    """One sparse CLI run of the render under the stage timers, checked:
    all views, ATE and rotation within the limits, median reprojection
    < 1 px. Returns the scene and the sfm stage's seconds."""
    from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

    stage_timer.enable()
    try:
        rc, log, wall = run_cli(argv, log_name)
        split = stage_timer.report()
    finally:
        stage_timer.enable(False)
    if rc != 0:
        raise AssertionError(f"{label} CLI exited {rc}")
    out = next(a.split("=", 1)[1] for a in argv if a.startswith("-Pout="))
    scene, med = check_outputs(out)
    rec, rel_ate, rot = trajectory_error(scene, gt_R, gt_C)
    feats = [int(v) for v in scene.feat_valid.sum(axis=1)]
    say(card, f"{label}: {len(rec)}/{n_views} views, features per image {feats} (capacity "
              f"{scene.feat_valid.shape[1]}), ATE {rel_ate:.5%} of extent (limit "
              f"{ate_limit:.2%}), max rel rot {rot:.4f} deg (limit {rot_limit} deg), median "
              f"reprojection {med:.4f} px (limit 1 px), "
              f"{int(scene.point_valid.sum())} points; CLI wall "
              f"{wall:.2f} s, features {split['features'][0]:.3f} s, sfm {split['sfm'][0]:.3f} s "
              f"(synchronising stage timers)")
    if len(rec) != n_views:
        raise AssertionError(f"{label} recovered {len(rec)}/{n_views} views")
    if not (rel_ate <= ate_limit and rot <= rot_limit and med < 1.0):
        raise AssertionError(f"{label}: ATE {rel_ate:.4%}, rot {rot} deg, reprojection {med} px")
    return scene, split["sfm"][0]


def phase_orb_real_size(card: str, work: str, n_views=12, h=1080, w=1920, f=1680.0) -> dict:
    """The 1080p render with ORB at full image size and -Pfeature-limit=0
    (capacity 65,536), sparse: limits ORB_ATE_LIMIT and ORB_ROT_LIMIT_DEG,
    median reprojection < 1 px, K1 launched once on the +-1 expansion at
    (12, 65536, 256). Then K1 alone, timed on the run's own descriptors.
    Then the SfM again on the run's features with each of ORB_SWEEP_SEEDS,
    so other RANSAC draws are seen too: each must recover every view within
    the ATE and rotation limits; their median reprojections are printed
    (the spatial merge's reach grows with the first baseline's length, see
    PERF.md)."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.models.cameras import make_intrinsics
    from sfm_mvs_pipeline_tpu_torch.models.scene import Scene
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import BIG, two_nn_batch
    from sfm_mvs_pipeline_tpu_torch.ops.pairs import make_pairs
    from sfm_mvs_pipeline_tpu_torch.sfm.incremental import SfMConfig, reconstruct
    from sfm_mvs_pipeline_tpu_torch.utils.stats import reprojection_errors

    data, gt_R, gt_C = render_once(card, work, n_views, h, w, f)
    out = os.path.join(work, "out-orb")
    argv = ["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out}",
            "-Pfeature-detector=ORB", "-Pfeature-limit=0"]
    K.two_nn_batch_fused.launches = 0
    scene, sfm_s = sparse_real_size_run(card, argv, "chip_smoke_orb_real_size.log", n_views,
                                        gt_R, gt_C, ORB_ATE_LIMIT, ORB_ROT_LIMIT_DEG,
                                        "ORB real-size")
    launches = K.two_nn_batch_fused.launches
    S, F, D = scene.descriptors.shape
    if launches != 1 or (F, D) != (65536, 256):
        raise AssertionError(f"ORB real-size: K1 launches {launches} on descriptors "
                             f"{scene.descriptors.shape}")
    # K1 alone on the run's descriptors, bf16 as the SfM passes them; the
    # plain version runs on them cut to the largest extent (the slots past
    # it are invalid in every shot, so no valid query's result changes)
    d_t = torch.from_numpy(scene.descriptors).cuda().to(torch.bfloat16)
    v_t = torch.from_numpy(scene.feat_valid).cuda()
    pairs = all_pairs(n_views)
    p_t = torch.from_numpy(pairs).cuda()
    ext = K.valid_extent(v_t).cpu().numpy()
    e = int(ext.max())
    out_k = K.two_nn_batch_fused(d_t, v_t, p_t)
    out_p = two_nn_batch(d_t[:, :e], v_t[:, :e].contiguous(), p_t)
    torch.cuda.synchronize()
    k1_extent_contract(tuple(x[:, :e] for x in out_k), out_p, v_t[:, :e], p_t, "ORB real-size")
    if not bool((out_k[1][:, e:] == BIG).all()):
        raise AssertionError("ORB real-size: K1 best^2 is not BIG past the largest extent")
    vq = v_t[p_t[:, 0].long(), :e]
    err = float(torch.maximum((out_k[1][:, :e] - out_p[1])[vq].abs().max(),
                              (out_k[2][:, :e] - out_p[2])[vq].abs().max()))
    del out_k, out_p
    ms = timed(lambda: K.two_nn_batch_fused(d_t, v_t, p_t), reps=5)
    flop = 2.0 * D * float((ext[pairs[:, 0]] * ext[pairs[:, 1]]).sum())
    b = match_bound(ext, pairs, F, D, "bf16", op_bytes=2)
    b_pad = match_bound(np.full(S, F), pairs, F, D, "bf16", op_bytes=2)
    say(card, f"ORB real-size: K1 launches {launches} at (S, F, D) ({S}, {F}, {D}), extents "
              f"{ext.tolist()}; K1 alone on the run's bf16 descriptors over {len(pairs)} pairs "
              f"holds its extent contract against the plain version (max abs err {err} at valid "
              f"queries), {ms:.3f} ms (median of 5), "
              f"{flop / ms / 1e9:.2f} bf16 TFLOP/s, {b['bound_ms'] / ms:.2%} of its "
              f"{b['bound_ms']:.3f} ms extent bound ({b['bound_by']}; padded bound "
              f"{b_pad['bound_ms']:.1f} ms); sfm stage {sfm_s:.3f} s ({card})")
    del d_t, v_t

    rows = []
    for seed in ORB_SWEEP_SEEDS:
        sweep = Scene.create(scene.image_paths, scene.image_size, scene.keypoints,
                             scene.descriptors, scene.feat_valid,
                             make_intrinsics(w, h).numpy().astype(np.float64))
        st = reconstruct(sweep, make_pairs("unordered", n_views),
                         SfMConfig(seed=seed, binary_descriptors=True), device=ONE_CARD)
        n_rec = int(sweep.recovered.sum())
        _, rel_ate, rot = trajectory_error(sweep, gt_R, gt_C) if n_rec >= 3 else (0, 1.0, 180.0)
        med = float(np.median(reprojection_errors(sweep))) if n_rec >= 2 else float("nan")
        rows.append((seed, n_rec, st["baseline"], st.get("attempts"), rel_ate, rot, med))
    say(card, "ORB real-size, SfM seeds on the run's features (seed, views, baseline, starts, "
              "ATE, max rel rot deg, median reprojection px): "
              + "; ".join(f"{r[0]}: {r[1]}/{n_views} {r[2]} {r[3]} {r[4]:.5%} {r[5]:.4f} "
                          f"{r[6]:.4f}" for r in rows))
    bad = [r for r in rows if r[1] != n_views or r[4] > ORB_ATE_LIMIT or r[5] > ORB_ROT_LIMIT_DEG]
    if bad:
        raise AssertionError(f"ORB real-size: seeds outside the limits: {bad}")
    return {"max_abs_err": err, "ms": ms, "launches": launches, **b,
            "padded_bound_ms": b_pad["bound_ms"], "sfm_s": sfm_s}


K1X_PHASE14_INPUTS = os.path.join(LOG_DIR, "k1x_phase14_inputs.npz")


def phase_exact_real_size(card: str, work: str, n_views=12, h=1080, w=1920, f=1680.0) -> dict:
    """-Pmatch-precision=exact on the 1080p render with SIFT: phase 4's
    limits, K1x launched once over the 66 pairs and K1 not at all. Then K1x
    and K1 on the run's own descriptors: SIFT's are continuous (L2-normalised
    to 512), so the two agree within SPLIT_REL_TOL, and the
    (idx, mask) tables of match_pairs_batch(exact=True) and (exact=False)
    differ only at entries that tolerance leaves open (a near-tie of best
    and second, or a ratio within it of the 0.49 boundary). Then K1x alone
    on them, timed twice (a median of 5 each) against its bound, with each
    shot's valid count, extent and occupied 64-slot tiles; the inputs are
    saved to K1X_PHASE14_INPUTS for --k1x-timing."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import match_pairs_batch, two_nn_batch, two_nn_exact

    data, gt_R, gt_C = render_once(card, work, n_views, h, w, f)
    out = os.path.join(work, "out-exact")
    argv = ["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out}", "-Pfeature-limit=0",
            "-Pmatch-precision=exact"]
    K.two_nn_batch_fused.launches = 0
    K.two_nn_exact_batch.launches = 0
    scene, _ = sparse_real_size_run(card, argv, "chip_smoke_exact_real_size.log", n_views, gt_R,
                                    gt_C, 0.001, 0.25, "exact real-size")
    launches, launches_1 = K.two_nn_exact_batch.launches, K.two_nn_batch_fused.launches
    if launches != 1 or launches_1 != 0:
        raise AssertionError(f"exact real-size: K1x launches {launches}, K1 {launches_1}")
    d_t = torch.from_numpy(scene.descriptors).cuda()
    v_t = torch.from_numpy(scene.feat_valid).cuda()
    pairs = all_pairs(n_views)
    p_t = torch.from_numpy(pairs).cuda()
    out_x = K.two_nn_exact_batch(d_t, v_t, p_t)
    plain = exact_agreement(out_x, two_nn_batch(d_t, v_t, p_t, nn=two_nn_exact), d_t, v_t, p_t,
                            "its plain version")
    agree = exact_agreement(out_x, K.two_nn_batch_fused(d_t, v_t, p_t), d_t, v_t, p_t, "K1",
                            SPLIT_REL_TOL)
    ix, mx = match_pairs_batch(d_t, v_t, p_t, exact=True)
    i1, m1 = match_pairs_batch(d_t, v_t, p_t, exact=False)
    differ = (mx != m1) | (mx & m1 & (ix != i1))
    if bool((differ & ~agree["loose"]).any()):
        raise AssertionError(f"exact and fast match tables differ at "
                             f"{int((differ & ~agree['loose']).sum())} entries the tolerance "
                             f"does not leave open")
    n_int = int((d_t == torch.round(d_t)).all(dim=-1)[v_t].sum())
    say(card, f"exact real-size: K1x launches {launches}, K1 {launches_1}; on the run's "
              f"descriptors {tuple(d_t.shape)} ({n_int} of {int(v_t.sum())} integer-valued) over "
              f"{len(pairs)} pairs, K1x vs its plain version max |d| {plain['max_abs_err']} "
              f"({plain['rel']:.3e} of |q|^2 + |t|^2, idx equal at {plain['apart']} separated "
              f"entries of {plain['valid']}), K1x vs K1 max |d| {agree['max_abs_err']} "
              f"({agree['rel']:.3e} of |q|^2 + |t|^2); exact and fast (idx, mask) tables differ "
              f"at {int(differ.sum())} of {int(m1.sum())} fast matches, all within tolerance "
              f"({agree['near']} entries near 0.49, {agree['valid'] - agree['apart']} near-ties)")
    del out_x, ix, mx, i1, m1

    S, F, D = scene.descriptors.shape
    valid = scene.feat_valid
    tiles = valid[:, : F // 64 * 64].reshape(S, -1, 64).any(axis=2).sum(axis=1)
    say(card, f"exact real-size, K1x's launch (S, F, D) = ({S}, {F}, {D}): valid counts "
              f"{valid.sum(axis=1).tolist()}, extents {K.valid_extent(v_t).cpu().tolist()}, "
              f"occupied 64-slot tiles {tiles.tolist()} of {F // 64}")
    np.savez(K1X_PHASE14_INPUTS, descriptors=scene.descriptors, valid=valid)
    ms = time_k1x(K, d_t, v_t, p_t)
    b, b_cap = k1x_bounds(valid, pairs, D)
    say(card, f"exact real-size: K1x alone {ms[0]:.4f}/{ms[1]:.4f} ms (median of 5, "
              f"compaction, operand build and scatter included), "
              f"{b['bound_ms'] / float(np.median(ms)):.2%} of its {b['bound_ms']:.4f} ms "
              f"bound over valid counts ({b['bound_by']}; capacity bound {b_cap['bound_ms']:.4f} "
              f"ms; {card})")
    return {"launches": launches, "phase14_ms": float(np.median(ms)),
            "phase14_bound_ms": b["bound_ms"], "phase14_capacity_bound_ms": b_cap["bound_ms"]}


def time_k1x(K, d_t, v_t, p_t) -> list[float]:
    """K1x of the module K on one input: two medians of 5 CUDA-event times
    (ms), after one warm-up call."""
    K.two_nn_exact_batch(d_t, v_t, p_t)
    return [timed(lambda: K.two_nn_exact_batch(d_t, v_t, p_t)) for _ in range(2)]


def k1x_timing(root: str, inputs: str | None) -> int:
    """--k1x-timing ROOT: K1x of the checkout at ROOT (this one or another,
    such as a parent commit unpacked beside it) built from its own sources
    and timed by time_k1x on phase 11's "cont" and "sift" inputs and, with
    --k1x-inputs, on phase 14's saved ones; on "sift" it is also held to the
    extent contract. Only that checkout's package is imported. Prints the
    times and no result line; exits 4."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch, two_nn_exact

    if not os.path.abspath(K.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {K.__file__}, not the checkout at {root}")
    card = card_line()
    print(card, flush=True)
    K.build()
    cases = {name: x for name, x in k1x_phase11_inputs().items() if name != "int"}
    if inputs:
        with np.load(inputs) as z:
            cases["phase14"] = (z["descriptors"], z["valid"])
    dev = torch.device("cuda")
    out = {}
    for name, (desc, valid) in cases.items():
        d_t, v_t = torch.from_numpy(desc).to(dev), torch.from_numpy(valid).to(dev)
        p_t = torch.from_numpy(all_pairs(len(desc))).to(dev)
        out[name] = time_k1x(K, d_t, v_t, p_t)
        if name == "sift":  # integer descriptors: what is timed is also right
            k1_extent_contract(K.two_nn_exact_batch(d_t, v_t, p_t),
                               two_nn_batch(d_t, v_t, p_t, nn=two_nn_exact), v_t, p_t, name)
        say(card, f"K1x of {root} on {name} {tuple(desc.shape)}: {out[name][0]:.4f}/"
                  f"{out[name][1]:.4f} ms (median of 5)")
        del d_t, v_t
    print(json.dumps({"k1x_timing": root, "ms": out}), flush=True)
    return 4


# ------------------------------------------------------------- phase 15
# the world-1 walls phase 15 prints its runs beside (phases 4, 7, 10)
WORLD1_WALLS: dict[str, float] = {}

# 15a: the sharded functions under torchrun on a run's scene
# (argv[1]) over the ranks' devices (argv[2]): the matcher (fast and exact),
# the depth maps (rect --sgm and PatchMatch on the scene's views) and, by
# argv[3], point-sharded BA ("bit": the default dtype, held bit for bit;
# "f64": float64, within BA_WORLD4_COST_REL / BA_WORLD4_ATOL with the same
# iterations; "-": none), every kernel's counts zeroed just before and read
# just after. Rank 0 then holds each to the one-device function on its
# first device: the matcher to match_pairs_batch, BA to
# run_bundle_adjustment, the depth maps to mvs/pipeline.py::depth_map_view
# called for each view in a plain loop outside the group. With argv[4]
# "digest", rank 0 also times the entry digest check on ORB's 1080p
# descriptor shape against hashing the bytes on the host. Prints
# "FUNCS_REPORT {json}" from every rank.
SHARDED_FUNCS = r"""
import hashlib, json, sys, time
import cv2
import numpy as np
import torch
import torch.distributed as dist
from sfm_mvs_pipeline_tpu_torch.models.cameras import CAMERA_MODELS
from sfm_mvs_pipeline_tpu_torch.mvs.neighbors import depth_range, select_neighbors
from sfm_mvs_pipeline_tpu_torch.mvs.pipeline import MVSConfig, _undistort_image, depth_map_view
from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import make_depth_planes
from sfm_mvs_pipeline_tpu_torch.mvs.rectified import derive_max_disp
from sfm_mvs_pipeline_tpu_torch.ops.kernels import build, match_kernel, pm_kernel, sgm_kernel
from sfm_mvs_pipeline_tpu_torch.ops.matching import match_pairs_batch
from sfm_mvs_pipeline_tpu_torch.ops.pairs import unordered_pairs
from sfm_mvs_pipeline_tpu_torch.parallel import distributed as D
from sfm_mvs_pipeline_tpu_torch.parallel.ba import run_bundle_adjustment_sharded
from sfm_mvs_pipeline_tpu_torch.parallel.matching import match_pairs_sharded
from sfm_mvs_pipeline_tpu_torch.parallel.mvs import compute_depth_maps_sharded, fixed_neighbor_table
from sfm_mvs_pipeline_tpu_torch.sfm.ba import run_bundle_adjustment
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer
from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene
from sfm_mvs_pipeline_tpu_torch.utils.images import load_rgb

scene_npz, devices, ba_mode, with_digest = sys.argv[1:5]
D.initialize_distributed(backend="gloo" if devices.startswith("cpu") else None)
rank, backend = dist.get_rank(), dist.get_backend()
shards = D.Shards(devices)
dev = shards.first
scene = load_scene(scene_npz)
desc = torch.as_tensor(scene.descriptors, device=dev)
valid = torch.as_tensor(scene.feat_valid, device=dev)
pairs = torch.as_tensor(unordered_pairs(scene.n_shots), device=dev)
imask = np.zeros((len(scene.intrinsics), 7))
imask[:, list(CAMERA_MODELS[scene.camera_model].opt_mask)] = 1.0
# the run's points moved off their optimum (1 mm at a ~10 m depth), so
# the sharded LM takes real steps
points = scene.points + np.random.default_rng(0).normal(size=scene.points.shape) * 1e-3
ba_args = (points, scene.poses, scene.intrinsics, scene.cam_of_shot,
           scene.obs_point, scene.obs_shot, scene.obs_uv.astype(np.float64),
           scene.obs_w.astype(np.float64), imask)
ba_kw = dict(pose_free=scene.recovered.astype(np.float64),
             **({"dtype": torch.float64} if ba_mode == "f64" else {}))
rec = [int(s) for s in np.nonzero(scene.recovered)[0]]
w, h = scene.image_size
intr = scene.intrinsics[0].copy()
grays = np.stack([cv2.cvtColor(_undistort_image(load_rgb(scene.image_paths[s], (w, h)), intr,
                                                dev).astype(np.uint8), cv2.COLOR_RGB2GRAY)
                  for s in rec]).astype(np.float32) / 255.0
intr[3:] = 0.0
poses = scene.poses[rec].astype(np.float32)
nbr_idx, nbr_valid = fixed_neighbor_table(select_neighbors(scene, 5), rec, 5)
planes = np.stack([make_depth_planes(*depth_range(scene, s), 96) for s in rec]).astype(np.float32)
md = max(derive_max_disp(poses[i], poses[nbr_idx[i][nbr_valid[i]]], float(intr[0]),
                         float(planes[i].min()), w) for i in range(len(rec)))
dm_kw = {"rect_sgm": dict(method="rect", use_sgm=True, max_disp=md),
         "patchmatch": dict(method="patchmatch", max_disp=md)}
kernels = (match_kernel.two_nn_batch_fused, match_kernel.two_nn_exact_batch,
           sgm_kernel.sgm_hpair, sgm_kernel.sgm_dir_acc, pm_kernel.pm_score_rect)


def depth_per_view(method, use_sgm=False, max_disp=256):
    # compute_depth_maps_sharded's defaults
    cfg = MVSConfig(n_neighbors=nbr_idx.shape[1], n_planes=planes.shape[1], method=method,
                    use_sgm=use_sgm)
    grays_d, poses_d = torch.as_tensor(grays, device=dev), torch.as_tensor(poses, device=dev)
    intr_d = torch.as_tensor(intr.astype(np.float32), device=dev)
    depth, valid = np.zeros(grays.shape, np.float32), np.zeros(grays.shape, bool)
    for i in range(len(rec)):
        nbrs = [int(n) for n in nbr_idx[i][nbr_valid[i]]]
        if nbrs:
            d, v, _ = depth_map_view(cfg, i, nbrs, grays_d, poses, poses_d, intr_d,
                                     float(intr[0]), float(planes[i].min()),
                                     float(planes[i].max()), w, planes=planes[i],
                                     max_disp=max_disp)
            depth[i], valid[i] = d.cpu().numpy(), v.cpu().numpy()
    return [depth, valid]


def sync():
    for d in {d for d in shards.devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def run(sharded):
    out, walls = {}, {}
    t0 = time.perf_counter()
    for x in ("fast", "exact"):
        res = (match_pairs_sharded(desc, valid, pairs, with_distance=True, exact=x == "exact",
                                   device=devices) if sharded else
               match_pairs_batch(desc, valid, pairs, with_distance=True, exact=x == "exact"))
        out["match_" + x] = [t.cpu().numpy() for t in res]
    sync()
    walls["match"] = time.perf_counter() - t0
    for name, kw in dm_kw.items():
        t0 = time.perf_counter()
        out["depth_" + name] = (list(compute_depth_maps_sharded(
            grays, poses, intr, nbr_idx, nbr_valid, planes, device=devices, **kw)) if sharded
            else depth_per_view(**kw))
        sync()
        walls["depth_" + name] = time.perf_counter() - t0
    if ba_mode != "-":
        t0 = time.perf_counter()
        out["ba"] = (run_bundle_adjustment_sharded(*ba_args, device=devices, **ba_kw) if sharded
                     else run_bundle_adjustment(*ba_args, device=dev, **ba_kw))
        sync()
        walls["ba"] = time.perf_counter() - t0
    return out, walls


def time_digest():
    # ORB at -Pfeature-limit=0 on the 1080p render: (12, 65536, 256) bf16 +-1
    x = (torch.randint(0, 2, (12, 65536, 256), device=dev, dtype=torch.int8) * 2 - 1).to(
        torch.bfloat16)
    D.digest(x)
    ms = {}
    for name, fn in (("device_fingerprint", lambda: D.digest(x)),
                     ("host_bytes", lambda: hashlib.blake2b(
                         x.reshape(-1).view(torch.uint8).cpu().numpy().tobytes(),
                         digest_size=8).digest())):
        ts = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        ms[name] = sorted(ts)[1]
    return {"shape": list(x.shape), "MB": x.numel() * 2 / 1e6, "ms": ms}


build.reset_launches(*kernels)
stage_timer.enable()
t0 = time.perf_counter()
sharded, walls = run(True)
wall = time.perf_counter() - t0
split = stage_timer.report()
D.shutdown_distributed()
stage_timer.enable(False)
report = {"rank": rank, "backend": backend, "kind": shards.kind, "held": shards.held,
          "devices": [str(d) for d in shards.devices], "wall_s": wall, "walls_s": walls,
          "launches": {k.__name__: k.launches for k in kernels},
          "by_card": {k.__name__: dict(sorted(k.by_card.items())) for k in kernels},
          "collectives": {k: v for k, v in split.items() if k.startswith("collective")}}
if rank == 0:
    ref, ref_walls = run(False)
    report.update(views=len(rec), max_disp=int(md), ref_walls_s=ref_walls)
    report["equal"] = {k: all(np.array_equal(a, b) for a, b in zip(sharded[k], ref[k]))
                       for k in sharded if k != "ba"}
    if ba_mode != "-":
        got, one = sharded["ba"], ref["ba"]
        fields = ("points", "poses", "intrinsics")
        if ba_mode == "bit":
            report["equal"]["ba"] = all(np.array_equal(got[k], one[k]) for k in fields + ("cost",))
            report["equal"]["ba_iterations"] = got["iterations"] == one["iterations"]
        report["ba"] = {
            "dtype": "float64" if ba_mode == "f64" else "the default",
            "observations": int((scene.obs_w > 0).sum()), "cost": float(got["cost"]),
            "ref_cost": float(one["cost"]),
            "rel": abs(float(got["cost"]) - float(one["cost"])) / abs(float(one["cost"])),
            "iterations": int(got["iterations"]), "ref_iterations": int(one["iterations"]),
            "max_abs": {k: float(np.abs(np.asarray(got[k], np.float64)
                                        - np.asarray(one[k], np.float64)).max()) for k in fields}}
    if with_digest == "digest":
        report["digest"] = time_digest()
print("FUNCS_REPORT " + json.dumps(report), flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cmd: list[str], env: dict, timeout: float) -> subprocess.CompletedProcess:
    """subprocess.run for a command that starts rank processes (torchrun):
    in a session of its own, so on the timeout every process it started is
    killed with it, and then TimeoutExpired is raised."""
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def torchrun_cli(argv: list[str], world: int, log_name: str, timeout: float,
                 env: dict | None = None) -> tuple[str, float]:
    """The port's CLI under torchrun at `world` ranks, with --stage-times
    (and `env` added to the ranks' environment); the ranks' backend follows
    the port's rule (gloo when ranks share a card, nccl when each has its
    own). Returns (the ranks' merged output, wall s); raises on a non-zero
    exit or after `timeout` s."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", "-m", "sfm_mvs_pipeline_tpu_torch", *argv, "--stage-times"]
    env = {**os.environ, "PYTHONPATH": ROOT,
           "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or world) // world)), **(env or {})}
    t0 = time.perf_counter()
    res = run_ranks(cmd, env, timeout)
    wall = time.perf_counter() - t0
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, log_name), "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise AssertionError(f"torchrun ({log_name}) exited {res.returncode}:\n"
                             f"{(res.stdout + res.stderr)[-3000:]}")
    return res.stdout, wall


def rank_report(log: str, world: int) -> list[dict]:
    """Each rank's --stage-times lines: {"stages": {name: (s, calls)},
    "launches": {kernel: n}}."""
    out = []
    for r in range(world):
        tag = f"r{r}/{world}]"
        st = re.search(re.escape(tag) + r" stage times: (.*)", log)
        kl = re.search(re.escape(tag) + r" kernel launches: (.*)", log)
        if not (st and kl):
            raise AssertionError(f"rank {r} logged no stage times or kernel launches")
        stages = {}
        for part in st.group(1).split("; "):
            name, secs, _, calls = part.rsplit(" ", 3)
            stages[name] = (float(secs), int(calls[1:]))
        launches = {m[0]: int(m[1]) for m in re.findall(r"(\w+) (\d+)", kl.group(1))}
        out.append({"stages": stages, "launches": launches})
    return out


def say_ranks(card: str, label: str, reports: list[dict], wall: float, world1: str) -> None:
    for r, rep in enumerate(reports):
        st = rep["stages"]
        say(card, f"{label} rank {r}: torchrun wall {wall:.2f} s ({world1}); stages "
                  + "; ".join(f"{k} {t:.3f} s x{n}" for k, (t, n) in st.items()))
        say(card, f"{label} rank {r}: kernel launches " + ", ".join(
            f"{k} {n}" for k, n in rep["launches"].items() if n))


def depth_maps_equal(out_a: str, out_b: str, n_views: int, label: str) -> None:
    for i in range(n_views):
        a = np.load(os.path.join(out_a, f"depth_{i:04d}.npy"))
        b = np.load(os.path.join(out_b, f"depth_{i:04d}.npy"))
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: depth map {i} differs at "
                                 f"{int((a != b).sum())} pixels")


def empty_kernel_builds() -> None:
    """Remove the built kernel libraries, so the next process builds them
    (this process keeps its loaded copies)."""
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import build, match_kernel, pm_kernel, sgm_kernel

    for src in (match_kernel.SOURCE, match_kernel.EXACT_SOURCE, sgm_kernel.SOURCE,
                pm_kernel.SOURCE):
        path = build.library_path(src)
        if os.path.exists(path):
            os.unlink(path)


def dryrun_at(card: str, world: int, args: tuple = (), env: dict | None = None,
              tag: str = "") -> tuple[str, float]:
    """parallel/dryrun.py at `world` ranks under torchrun (with `args`, and
    `env` added to the ranks' environment), the backend by the port's rule
    (gloo when ranks share a card, nccl when each has its own), from an
    emptied kernel build dir: every rank builds K1, K1x, K2 and K3 at once
    (build.py writes a temporary file and renames it). Returns (the ranks'
    output, wall s)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", "-m", "sfm_mvs_pipeline_tpu_torch.parallel.dryrun", *args]
    empty_kernel_builds()
    t0 = time.perf_counter()
    res = run_ranks(cmd, {**os.environ, "PYTHONPATH": ROOT, **(env or {})}, 300)
    wall = time.perf_counter() - t0
    with open(os.path.join(LOG_DIR, f"chip_smoke_dryrun_world{world}{tag}.log"), "w") as f:
        f.write(res.stdout + res.stderr)
    ok = [f"dryrun rank {r} of {world}: OK" in res.stdout for r in range(world)]
    if res.returncode != 0 or not all(ok):
        raise AssertionError(f"dryrun at world {world} exited {res.returncode}:\n"
                             f"{(res.stdout + res.stderr)[-3000:]}")
    backend = re.search(r"backend (\w+)", res.stdout).group(1)
    say(card, f"dryrun at world {world} ({backend}), every rank building the kernels at once "
              f"from an emptied build dir: OK in {wall:.2f} s")
    return res.stdout, wall


def phase_world2(card: str, work: str, n_views=12, h=1080, w=1920, f=1680.0) -> dict:
    """15b: the dryrun at world 2 from an emptied kernel build dir (both
    ranks build every kernel at once), then the 1080p render through the
    CLI at world 2 under torchrun (gloo, both ranks on this card) with phase
    7's flags and --artifacts.
    Phase 4's and 7's limits; the three sharded branches on both ranks, K1
    and K2b launched on each, only rank 0 wrote, and the depth maps
    bit-equal to a world-1 run resumed from the run's scene.npz.
    15c: the same at world 2 resumed from that scene.npz with PatchMatch:
    K3 launched on each rank, phase 10's limit, depth maps bit-equal to a
    world-1 PatchMatch run from the same scene.npz. The ranks see card 0
    only, so on a host of several cards too they share it on gloo. Returns
    each rank's launches."""
    import torch

    torch.cuda.empty_cache()
    data, gt_R, gt_C = render_once(card, work, n_views, h, w, f)
    one_card = visible_cards(1)
    dryrun_at(card, 2, env=one_card)
    out2 = os.path.join(work, "out-w2")
    argv = ["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out2}", "-Pfeature-limit=0",
            "--dense", "--sgm", "--mesh", "--colored", "--stats", "--artifacts"]
    log, wall = torchrun_cli(argv, 2, "chip_smoke_world2.log", 900, one_card)
    reports = rank_report(log, 2)
    scene, med = check_outputs(out2)
    rec, rel_ate, rot = trajectory_error(scene, gt_R, gt_C)
    share, n_pts = dense_accuracy(out2, gt_R, gt_C)
    n_live = int((scene.obs_w > 0).sum())
    ba_sharded = len(re.findall(r"r0/2\] BA #\d+: .*point-sharded over 2 ranks", log))
    ba_runs = len(re.findall(r"r0/2\] BA #\d+", log))
    say(card, f"world 2 (gloo, one card): {len(rec)}/{n_views} views, ATE {rel_ate:.5%} of extent, "
              f"max rel rot {rot:.4f} deg, median reprojection {med:.4f} px, {n_pts} dense points, "
              f"{share:.4%} within 1% of depth (limit {DENSE_SHARE_LIMIT:.0%}), {n_live} live "
              f"observations, {ba_sharded} of {ba_runs} BA runs point-sharded")
    world1 = ", ".join(f"{k} {v:.2f} s" for k, v in WORLD1_WALLS.items()) or "world-1 phases not run"
    say_ranks(card, "world 2", reports, wall, "world 1: " + world1)
    iters = sum(int(m) for m in re.findall(
        r"r0/2\] BA #\d+: .*\((\d+) iters, .*point-sharded over 2 ranks", log))
    for r, rep in enumerate(reports):
        t_red, n_red = rep["stages"].get("collective all_reduce", (0.0, 0))
        t_gat, n_gat = rep["stages"].get("collective all_gather", (0.0, 0))
        say(card, f"world 2 rank {r}: all_reduce {t_red:.4f} s x{n_red} "
                  f"({t_red / max(iters, 1) * 1e3:.3f} ms per sharded LM iteration, {iters} "
                  f"iterations), all_gather {t_gat:.4f} s x{n_gat} (synchronising timers)")
    if len(rec) != n_views or not (rel_ate <= 0.001 and rot <= 0.25 and med < 1.0):
        raise AssertionError(f"world 2: {len(rec)} views, ATE {rel_ate}, rot {rot}, reproj {med}")
    if not share >= DENSE_SHARE_LIMIT:
        raise AssertionError(f"world 2: {share:.4%} of dense points on the surfaces")
    for r in range(2):
        for what in ("SfM r{r}/2] pair-sharded matching over 2 ranks",
                     "MVS r{r}/2] view-sharded depth maps over 2 ranks"):
            if what.format(r=r) not in log:
                raise AssertionError(f"world 2: rank {r} did not log {what.format(r=r)!r}")
        lr = reports[r]["launches"]
        if lr["two_nn_batch_fused"] <= 0 or lr["sgm_hpair"] <= 0 or lr["sgm_dir_acc"] <= 0:
            raise AssertionError(f"world 2: rank {r} launches {lr}")
    if ba_sharded == 0 and n_live >= 2 * 2048:
        raise AssertionError("world 2: no BA run took the point-sharded branch")
    if f"r1/2] reprojection error" in log or "r0/2] reprojection error" not in log:
        raise AssertionError("world 2: the statistics were not written by rank 0 alone")
    ref = os.path.join(work, "out-w1-sgm")
    rc, _, wall1 = run_cli(["-Prun=photogrammetrie", f"-Presume={out2}/scene.npz",
                            f"-Pout={ref}", "--dense", "--sgm", "--artifacts"],
                           "chip_smoke_world1_sgm_ref.log")
    if rc != 0:
        raise AssertionError(f"world-1 --sgm reference exited {rc}")
    depth_maps_equal(out2, ref, n_views, "world 2 --sgm")
    say(card, f"world 2 --sgm: {n_views} depth maps bit-equal to the world-1 run resumed from "
              f"its scene.npz (reference dense wall {wall1:.2f} s)")

    out3 = os.path.join(work, "out-w2-pm")
    argv = ["-Prun=photogrammetrie", f"-Presume={out2}/scene.npz", f"-Pout={out3}",
            "-Pdense-method=patchmatch", "--dense", "--mesh", "--colored", "--stats",
            "--artifacts"]
    log_pm, wall_pm = torchrun_cli(argv, 2, "chip_smoke_world2_pm.log", 600, one_card)
    reports_pm = rank_report(log_pm, 2)
    share_pm, n_pm = dense_accuracy(out3, gt_R, gt_C)
    say(card, f"world 2 PatchMatch: {n_pm} dense points, {share_pm:.4%} within 1% of depth "
              f"(limit {PM_DENSE_SHARE_LIMIT:.0%})")
    say_ranks(card, "world 2 PatchMatch", reports_pm, wall_pm, "world 1: " + world1)
    for r in range(2):
        if reports_pm[r]["launches"]["pm_score_rect"] <= 0:
            raise AssertionError(f"world 2 PatchMatch: rank {r} never launched K3")
    if not share_pm >= PM_DENSE_SHARE_LIMIT:
        raise AssertionError(f"world 2 PatchMatch: {share_pm:.4%} of points on the surfaces")
    ref = os.path.join(work, "out-w1-pm")
    rc, _, _ = run_cli(["-Prun=photogrammetrie", f"-Presume={out2}/scene.npz", f"-Pout={ref}",
                        "-Pdense-method=patchmatch", "--dense", "--artifacts"],
                       "chip_smoke_world1_pm_ref.log")
    if rc != 0:
        raise AssertionError(f"world-1 PatchMatch reference exited {rc}")
    depth_maps_equal(out3, ref, n_views, "world 2 PatchMatch")
    say(card, f"world 2 PatchMatch: {n_views} depth maps bit-equal to the world-1 run")
    return {"sgm": [rp["launches"] for rp in reports],
            "patchmatch": [rp["launches"] for rp in reports_pm]}


def visible_cards(n: int) -> dict:
    """The environment that shows a subprocess the first n cards this
    process sees (none on the CPU)."""
    import torch

    if not torch.cuda.is_available():
        return {}
    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = seen.split(",") if seen else [str(i) for i in range(torch.cuda.device_count())]
    return {"CUDA_VISIBLE_DEVICES": ",".join(ids[:n])}


def by_card_counts(text: str) -> dict:
    """{kernel: {card: n}} from a "kernel launches by card" list such as
    "two_nn_batch_fused 0:1/1:1, sgm_hpair 0:15/1:15"."""
    return {name: {int(c): int(n) for c, n in re.findall(r"(\d+):(\d+)", counts)}
            for name, counts in re.findall(r"(\w+) ([\d:/]*)", text)}


def check_card_launches(label: str, by_rank: list[dict], cards: list[list[int]],
                        kernels: list[str], idle: tuple = ()) -> None:
    """Each kernel in `kernels` launched on every card of every rank
    (cards[r]) but the (rank, card) pairs in `idle`, which have no work,
    and on none of those."""
    for r, own in enumerate(cards):
        for c in own:
            for name in kernels:
                n = by_rank[r].get(name, {}).get(c, 0)
                if (n > 0) == ((r, c) in idle):
                    raise AssertionError(f"{label}: rank {r} launched {name} {n} times on card "
                                         f"{c} (without work: {idle})")


def sharded_functions(card: str, label: str, scene_npz: str, devices: str, world: int,
                      env: dict, backend: str, ba: str, digest: bool = False) -> list[dict]:
    """SHARDED_FUNCS under torchrun at `world` ranks (`env` added to their
    environment), each rank on `devices`, on a run's scene: `backend` by
    the port's rule, the matcher and depth maps (and BA with ba "bit")
    bit-equal to one device, BA "f64" within the world-4 tolerance, every
    kernel launched on every card of every rank. Returns each rank's
    report."""
    script = os.path.join(os.path.dirname(scene_npz), "sharded_functions.py")
    with open(script, "w") as f:
        f.write(SHARDED_FUNCS)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", script, scene_npz, devices, ba,
           "digest" if digest else "-"]
    t0 = time.perf_counter()
    res = run_ranks(cmd, {**os.environ, "PYTHONPATH": ROOT, **env}, 600)
    wall = time.perf_counter() - t0
    with open(os.path.join(LOG_DIR, f"chip_smoke_{label.split()[0]}_functions.log"), "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise AssertionError(f"{label} exited {res.returncode}:\n"
                             f"{(res.stdout + res.stderr)[-3000:]}")
    reports = sorted((json.loads(ln.split("FUNCS_REPORT ", 1)[1])
                      for ln in res.stdout.splitlines() if ln.startswith("FUNCS_REPORT ")),
                     key=lambda r: r["rank"])
    if len(reports) != world:
        raise AssertionError(f"{label}: {len(reports)} reports of {world} ranks")
    r0 = reports[0]
    say(card, f"{label} ({r0['backend']}, {r0['kind']}) in {wall:.2f} s on {r0['views']} views "
              f"(rect max_disp {r0['max_disp']}): bit-equal to one device {r0['equal']}; walls "
              + "; ".join(f"rank {r['rank']} {r['devices']} "
                          + ", ".join(f"{k} {v:.3f} s" for k, v in r["walls_s"].items())
                          for r in reports)
              + "; one device " + ", ".join(f"{k} {v:.3f} s" for k, v in r0["ref_walls_s"].items()))
    for r in reports:
        say(card, f"{label} rank {r['rank']}: launches {r['launches']}, by card "
                  + per_card({k: {int(c): n for c, n in v.items()} for k, v in r["by_card"].items()})
                  + "; collectives " + "; ".join(f"{k.split(' ', 1)[1]} {t:.4f} s x{n}"
                                                 for k, (t, n) in r["collectives"].items()))
    if r0["backend"] != backend:
        raise AssertionError(f"{label} ran on {r0['backend']}, not {backend}")
    if not all(r0["equal"].values()):
        raise AssertionError(f"{label}: not bit-equal to one device: {r0['equal']}")
    if "ba" in r0:
        b = r0["ba"]
        say(card, f"{label}: sharded BA ({b['dtype']} dtype, {b['observations']} observations) "
                  f"cost {b['cost']!r} vs one device {b['ref_cost']!r} (rel {b['rel']:.3e}), "
                  f"{b['iterations']} iterations vs {b['ref_iterations']}, max |d| "
                  + ", ".join(f"{k} {v:.3e}" for k, v in b["max_abs"].items())
                  + (f" (limits rel {BA_WORLD4_COST_REL:g}, |d| {BA_WORLD4_ATOL:g})"
                     if ba == "f64" else " (held bit for bit)"))
        if ba == "f64" and not (b["rel"] <= BA_WORLD4_COST_REL
                                and b["iterations"] == b["ref_iterations"]
                                and max(b["max_abs"].values()) <= BA_WORLD4_ATOL):
            raise AssertionError(f"{label}: sharded BA outside the world-4 tolerance: {b}")
    if digest:
        dg = r0["digest"]
        say(card, f"entry digest of {tuple(dg['shape'])} bf16 ({dg['MB']:.1f} MB) on the card: "
                  f"device fingerprint {dg['ms']['device_fingerprint']:.3f} ms, host bytes + "
                  f"blake2b {dg['ms']['host_bytes']:.3f} ms (median of 3)")
    cards = [sorted({int(d.split(":")[1]) for d in r["devices"] if d.startswith("cuda")})
             for r in reports]
    check_card_launches(label, [{k: {int(c): n for c, n in v.items()}
                                 for k, v in r["by_card"].items()} for r in reports], cards,
                        ["two_nn_batch_fused", "two_nn_exact_batch", "sgm_hpair", "sgm_dir_acc",
                         "pm_score_rect"])
    return reports


def phase_nccl_world1(card: str, work: str) -> dict:
    """15a: SHARDED_FUNCS in a one-rank nccl group on card 0, on 15b's
    scene.npz, BA in the default dtype held bit for bit, and the entry
    digest timed. Returns the sharded calls' kernel launches."""
    r = sharded_functions(card, "15a world 1", os.path.join(work, "out-w2", "scene.npz"), "cuda",
                          1, visible_cards(1), "nccl", "bit", digest=True)[0]
    return r["launches"]


# ------------------------------------------------------------- phase 16
WORLD4 = 4

# 16, I-2b: point-sharded BA at world 4 on nccl on the scene of I-2 (its
# BA problem with the points moved 1 mm off their optimum, as in 15a), in
# float64 and float32; rank 0 then runs run_bundle_adjustment on its card.
# Prints one line "BA_REPORT {json}" from rank 0.
NCCL_WORLD4_BA = r"""
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
from sfm_mvs_pipeline_tpu_torch.models.cameras import CAMERA_MODELS
from sfm_mvs_pipeline_tpu_torch.parallel import distributed as D
from sfm_mvs_pipeline_tpu_torch.parallel.ba import run_bundle_adjustment_sharded
from sfm_mvs_pipeline_tpu_torch.sfm.ba import run_bundle_adjustment
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer
from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene

D.initialize_distributed()
rank = dist.get_rank()
dev = torch.device("cuda", torch.cuda.current_device())
scene = load_scene(sys.argv[1])
imask = np.zeros((len(scene.intrinsics), 7))
imask[:, list(CAMERA_MODELS[scene.camera_model].opt_mask)] = 1.0
points = scene.points + np.random.default_rng(0).normal(size=scene.points.shape) * 1e-3
ba_args = (points, scene.poses, scene.intrinsics, scene.cam_of_shot,
           scene.obs_point, scene.obs_shot, scene.obs_uv.astype(np.float64),
           scene.obs_w.astype(np.float64), imask)
runs = {}
for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
    kw = dict(pose_free=scene.recovered.astype(np.float64), dtype=dtype, device=dev)
    stage_timer.enable()
    t0 = time.perf_counter()
    out = run_bundle_adjustment_sharded(*ba_args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = stage_timer.report()
    stage_timer.enable(False)
    runs[name] = (kw, out, wall, split)
D.shutdown_distributed()
if rank == 0:
    report = {"observations": int((scene.obs_w > 0).sum())}
    for name, (kw, out, wall, split) in runs.items():
        ref = run_bundle_adjustment(*ba_args, **kw)
        report[name] = {
            "cost": float(out["cost"]), "ref_cost": float(ref["cost"]),
            "rel": abs(float(out["cost"]) - float(ref["cost"])) / abs(float(ref["cost"])),
            "iterations": int(out["iterations"]), "ref_iterations": int(ref["iterations"]),
            "max_abs": {k: float(np.abs(np.asarray(out[k], np.float64)
                                        - np.asarray(ref[k], np.float64)).max())
                        for k in ("points", "poses", "intrinsics")},
            "wall_s": wall,
            "collectives": {k: v for k, v in split.items() if k.startswith("collective")}}
    print("BA_REPORT " + json.dumps(report), flush=True)
"""
# tests/test_torch_parallel.py's tolerance for BA (float64) at world 4 on gloo
BA_WORLD4_COST_REL = 1e-9
BA_WORLD4_ATOL = 1e-7


def nccl_cards(log: str, world: int, label: str) -> list[str]:
    """Each rank's card ("GPU-<uuid>, PCI bus <bus>") from its process-group
    line; raises unless every rank chose nccl by the backend rule, took
    cuda:<LOCAL_RANK> and the cards are distinct."""
    cards = []
    for r in range(world):
        m = re.search(rf"r{r}/{world}\] process group: rank {r} of {world}, backend (\w+) "
                      rf"\(\d+ local rank\(s\) on (\d+) card\(s\); this rank's card: (\d+) "
                      rf"([^)]*)\)", log)
        if not m:
            raise AssertionError(f"{label}: rank {r} logged no process-group line with its card")
        if m.group(1) != "nccl" or int(m.group(3)) != r:
            raise AssertionError(f"{label}: rank {r} took backend {m.group(1)} on card "
                                 f"{m.group(3)} of {m.group(2)}")
        cards.append(m.group(4))
    if len(set(cards)) != world:
        raise AssertionError(f"{label}: the ranks' cards are not distinct: {cards}")
    return cards


def files_equal(out_a: str, out_b: str, names: list[str], label: str) -> None:
    for name in names:
        with open(os.path.join(out_a, name), "rb") as fa, open(os.path.join(out_b, name), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{label}: {name} differs from the world-1 run's")


# phase 16's torchrun walls by run (I-2, ...), which phase 17b prints its
# one-process walls beside
TORCHRUN_WALLS: dict[str, float] = {}


def world4_run(card: str, label: str, argv: list[str], log_name: str, timeout: float,
               kernels: list[str], idle_ranks: tuple = ()) -> tuple[str, list[dict]]:
    """One CLI run at world 4 under torchrun, checked: nccl by rule on four
    distinct cards, and each kernel in `kernels` launched on every rank
    but `idle_ranks` (ranks with no work) and on no rank of those. Prints
    each rank's stage split, collectives and launches. Returns (log,
    per-rank reports)."""
    log, wall = torchrun_cli(argv, WORLD4, log_name, timeout)
    TORCHRUN_WALLS[label.split()[0]] = wall
    cards = nccl_cards(log, WORLD4, label)
    reports = rank_report(log, WORLD4)
    world1 = ", ".join(f"{k} {v:.2f} s" for k, v in WORLD1_WALLS.items()) or "world-1 phases not run"
    say(card, f"{label}: torchrun wall {wall:.2f} s on four cards (nccl; "
              + "; ".join(f"rank {r} card {r} {c}" for r, c in enumerate(cards)) + ")")
    say_ranks(card, label, reports, wall, "world 1: " + world1)
    for r, rep in enumerate(reports):
        n = {k: rep["launches"][k] for k in kernels}
        if r in idle_ranks and any(n.values()) or r not in idle_ranks and not all(n.values()):
            raise AssertionError(f"{label}: rank {r} launches {n} (ranks without work: "
                                 f"{idle_ranks})")
    return log, reports


def rank0_alone_finished(label: str, log: str, reports: list[dict], dense: bool,
                         stats: bool = True, world: int = WORLD4) -> None:
    """Only rank 0 wrote: it alone logs the statistics it writes with
    --stats (a run from images) and, in a dense run, the dense cloud it
    fused; and only rank 0 fused, meshed and textured: ranks > 0 stop after
    the depth-map gather."""
    for what in ["reprojection error"] * stats + ["fused dense cloud"] * dense:
        if f"r0/{world}] {what}" not in log or re.search(rf"r[1-9]\d*/{world}\] {what}", log):
            raise AssertionError(f"{label}: {what!r} was not logged by rank 0 alone")
    if not dense:
        return
    for r, rep in enumerate(reports):
        post = {"fusion", "mesh", "texture", "refine"} & set(rep["stages"])
        if "depth-map gather" not in rep["stages"] or bool(post) != (r == 0):
            raise AssertionError(f"{label}: rank {r} ran stages {sorted(rep['stages'])}")


def phase_world4(card: str, work: str, n_views=12, h=1080, w=1920, f=1680.0) -> dict:
    """Phase 16: the multi-device paths on four cards, one rank a card,
    nccl by the backend rule, through the CLI under torchrun (see the
    module docstring, runs I-1 to I-6). Every world-1 reference runs in
    this process on card 0 from the same scene.npz. Returns each kernel's
    launches per rank."""
    import torch

    n_cards = torch.cuda.device_count()
    if n_cards < WORLD4:
        raise AssertionError(f"phase 16 needs four cards; this machine has {n_cards}")
    say(card, f"phase 16 on {n_cards} cards: " + " | ".join(card_lines()))
    torch.cuda.empty_cache()
    data, gt_R, gt_C = render_once(card, work, n_views, h, w, f)
    launches = {}

    # I-1: the dryrun from an emptied build dir, four ranks building at once
    log, _ = dryrun_at(card, WORLD4)
    nccl_cards(log, WORLD4, "I-1 dryrun")
    dry = [dict((k, int(n)) for k, n in re.findall(r"(\w+) (\d+)", line.split("launches ")[1]))
           for line in sorted(ln for ln in log.splitlines() if "dryrun rank" in ln)]
    if not all(all(d.values()) for d in dry):
        raise AssertionError(f"I-1 dryrun: a kernel was not launched on a rank: {dry}")
    say(card, f"I-1 dryrun kernel launches per rank: {dry}")

    # I-2: phase 7's flags from the images
    out2 = os.path.join(work, "out-w4")
    dense_flags = ["--dense", "--sgm", "--mesh", "--colored"]
    log, reports = world4_run(
        card, "I-2 --sgm", ["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out2}",
                            "-Pfeature-limit=0", *dense_flags, "--stats", "--artifacts"],
        "chip_smoke_world4_sgm.log", 600, ["two_nn_batch_fused", "sgm_hpair", "sgm_dir_acc"])
    scene, med = check_outputs(out2)
    rec, rel_ate, rot = trajectory_error(scene, gt_R, gt_C)
    share, n_pts = dense_accuracy(out2, gt_R, gt_C)
    _, n_faces = ply_counts(os.path.join(out2, "mesh_dense.ply"))
    n_live = int((scene.obs_w > 0).sum())
    gate = 2048 * WORLD4  # sfm/incremental.py::_SHARDED_BA_MIN_OBS x world
    ba = re.findall(r"r0/4\] BA #\d+: cost \S+ \((\d+) iters.*?(, point-sharded over 4 ranks)?$",
                    log, re.M)
    iters = sum(int(it) for it, sh in ba if sh)
    n_sharded = sum(1 for _, sh in ba if sh)
    say(card, f"I-2 --sgm: {len(rec)}/{n_views} views, ATE {rel_ate:.5%} of extent, max rel rot "
              f"{rot:.4f} deg, median reprojection {med:.4f} px, {n_pts} dense points, "
              f"{share:.4%} within 1% of depth (limit {DENSE_SHARE_LIMIT:.0%}), {n_faces} faces; "
              f"{n_sharded} of {len(ba)} BA runs crossed the gate of {gate} live observations "
              f"({n_live} at the end) and ran point-sharded, {iters} LM iterations")
    for r, rep in enumerate(reports):
        st = rep["stages"]
        t_red, n_red = st.get("collective all_reduce", (0.0, 0))
        t_dm = st.get("depth-map gather", (0.0, 0))[0]
        say(card, f"I-2 rank {r}: collectives "
                  + "; ".join(f"{k.split(' ', 1)[1]} {t:.4f} s x{n}" for k, (t, n) in st.items()
                              if k.startswith("collective"))
                  + f"; all_reduce {t_red / max(iters, 1) * 1e3:.3f} ms per sharded LM "
                  f"iteration; depth-map gather {t_dm * 1e3:.2f} ms (synchronising timers)")
    if len(rec) != n_views or not (rel_ate <= 0.001 and rot <= 0.25 and med < 1.0):
        raise AssertionError(f"I-2: {len(rec)} views, ATE {rel_ate}, rot {rot}, reproj {med}")
    if not share >= DENSE_SHARE_LIMIT or n_pts <= 0 or n_faces <= 0:
        raise AssertionError(f"I-2: {share:.4%} of {n_pts} dense points on the surfaces, "
                             f"{n_faces} faces")
    for r in range(WORLD4):
        for what in (f"SfM r{r}/4] pair-sharded matching over 4 ranks",
                     f"MVS r{r}/4] view-sharded depth maps over 4 ranks"):
            if what not in log:
                raise AssertionError(f"I-2: rank {r} did not log {what!r}")
    rank0_alone_finished("I-2", log, reports, dense=True)
    launches["k1"] = [rp["launches"]["two_nn_batch_fused"] for rp in reports]
    launches["k2b"] = [rp["launches"]["sgm_hpair"] + rp["launches"]["sgm_dir_acc"]
                       for rp in reports]
    ref2 = os.path.join(work, "out-w4-ref-sgm")
    rc, _, wall1 = run_cli(["-Prun=photogrammetrie", f"-Presume={out2}/scene.npz",
                            f"-Pout={ref2}", *dense_flags, "--artifacts"],
                           "chip_smoke_world4_ref_sgm.log")
    if rc != 0:
        raise AssertionError(f"I-2 world-1 reference exited {rc}")
    depth_maps_equal(out2, ref2, n_views, "I-2")
    files_equal(out2, ref2, ["pointcloud_dense.ply", "mesh_dense.ply"], "I-2")
    say(card, f"I-2: {n_views} depth maps bit-equal, pointcloud_dense.ply and mesh_dense.ply "
              f"identical to a world-1 run on card 0 resumed from its scene.npz (wall "
              f"{wall1:.2f} s)")

    # I-2b: point-sharded BA at world 4 on I-2's scene against world 1
    ba_r = world4_ba(card, os.path.join(out2, "scene.npz"))
    f64 = ba_r["f64"]
    if not (f64["rel"] <= BA_WORLD4_COST_REL and f64["iterations"] == f64["ref_iterations"]
            and max(f64["max_abs"].values()) <= BA_WORLD4_ATOL):
        raise AssertionError(f"I-2b: sharded BA (float64) outside the world-4 tolerance: {f64}")

    # I-3: PatchMatch resumed from I-2's scene.npz
    out3 = os.path.join(work, "out-w4-pm")
    pm_flags = ["-Pdense-method=patchmatch", "--dense", "--mesh", "--colored"]
    log, reports = world4_run(
        card, "I-3 PatchMatch", ["-Prun=photogrammetrie", f"-Presume={out2}/scene.npz",
                                 f"-Pout={out3}", *pm_flags, "--stats", "--artifacts"],
        "chip_smoke_world4_pm.log", 600, ["pm_score_rect"])
    share_pm, n_pm = dense_accuracy(out3, gt_R, gt_C)
    _, n_faces = ply_counts(os.path.join(out3, "mesh_dense.ply"))
    say(card, f"I-3 PatchMatch: {n_pm} dense points, {share_pm:.4%} within 1% of depth (limit "
              f"{PM_DENSE_SHARE_LIMIT:.0%}), {n_faces} faces")
    if not share_pm >= PM_DENSE_SHARE_LIMIT or n_pm <= 0 or n_faces <= 0:
        raise AssertionError(f"I-3: {share_pm:.4%} of {n_pm} points on the surfaces, "
                             f"{n_faces} faces")
    rank0_alone_finished("I-3", log, reports, dense=True, stats=False)
    launches["k3"] = [rp["launches"]["pm_score_rect"] for rp in reports]
    ref3 = os.path.join(work, "out-w4-ref-pm")
    rc, _, wall1 = run_cli(["-Prun=photogrammetrie", f"-Presume={out2}/scene.npz",
                            f"-Pout={ref3}", *pm_flags, "--artifacts"],
                           "chip_smoke_world4_ref_pm.log")
    if rc != 0:
        raise AssertionError(f"I-3 world-1 reference exited {rc}")
    depth_maps_equal(out3, ref3, n_views, "I-3")
    files_equal(out3, ref3, ["pointcloud_dense.ply", "mesh_dense.ply"], "I-3")
    say(card, f"I-3: {n_views} depth maps bit-equal, pointcloud_dense.ply and mesh_dense.ply "
              f"identical to the world-1 run (wall {wall1:.2f} s)")

    # I-4: -Pmatch-precision=exact (phase 14's flags), K1x pair-sharded
    out4 = os.path.join(work, "out-w4-exact")
    log, reports = world4_run(
        card, "I-4 exact", ["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out4}",
                            "-Pfeature-limit=0", "-Pmatch-precision=exact", "--stats"],
        "chip_smoke_world4_exact.log", 300, ["two_nn_exact_batch"])
    if any(rp["launches"]["two_nn_batch_fused"] for rp in reports):
        raise AssertionError("I-4: K1 launched in exact mode")
    world4_sparse_limits(card, "I-4", out4, n_views, gt_R, gt_C, 0.001, 0.25)
    rank0_alone_finished("I-4", log, reports, dense=False)
    launches["k1x"] = [rp["launches"]["two_nn_exact_batch"] for rp in reports]

    # I-5: ORB at -Pfeature-limit=0 (phase 13's flags): K1's bf16 route at
    # (12, 65536, 256), the entry digest of 403 MB on every rank, rank 0
    # writing the 805 MB scene.npz
    out5 = os.path.join(work, "out-w4-orb")
    log, reports = world4_run(
        card, "I-5 ORB", ["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out5}",
                          "-Pfeature-detector=ORB", "-Pfeature-limit=0", "--stats"],
        "chip_smoke_world4_orb.log", 600, ["two_nn_batch_fused"])
    scene5 = world4_sparse_limits(card, "I-5", out5, n_views, gt_R, gt_C, ORB_ATE_LIMIT,
                                  ORB_ROT_LIMIT_DEG)
    from sfm_mvs_pipeline_tpu_torch.cli.photogrammetrie import _feature_cap

    if scene5.descriptors.shape[1:] != (_feature_cap(1 << 18, w, h), 256):  # 65,536 at 1080p
        raise AssertionError(f"I-5: descriptors {scene5.descriptors.shape}")
    rank0_alone_finished("I-5", log, reports, dense=False)
    launches["k1_orb"] = [rp["launches"]["two_nn_batch_fused"] for rp in reports]
    say(card, f"I-5: rank 0 wrote scene.npz ({os.path.getsize(os.path.join(out5, 'scene.npz')) / 1e6:.1f}"
              f" MB) in its outputs stage of {reports[0]['stages']['outputs'][0]:.3f} s")

    # I-6: insel, phase 6's flags: 3 views and 3 pairs for 4 ranks
    out6 = os.path.join(work, "out-w4-insel")
    insel = os.path.join(ROOT, "sample_data", "insel")
    log, reports = world4_run(
        card, "I-6 insel --sgm", ["-Prun=photogrammetrie", f"-Pimage={insel}", f"-Pout={out6}",
                                  *dense_flags, "--stats", "--artifacts"],
        "chip_smoke_world4_insel.log", 300, ["sgm_bidir"], idle_ranks=(3,))
    scene6, med6 = check_outputs(out6)
    n_pts, _ = ply_counts(os.path.join(out6, "pointcloud_dense.ply"))
    _, n_faces = ply_counts(os.path.join(out6, "mesh_dense.ply"))
    say(card, f"I-6 insel: {int(scene6.recovered.sum())}/3 views, median reprojection "
              f"{med6:.4f} px, {n_pts} dense points, {n_faces} faces")
    if int(scene6.recovered.sum()) != 3 or not med6 < 1.0 or n_pts <= 0 or n_faces <= 0:
        raise AssertionError(f"I-6: {int(scene6.recovered.sum())}/3 views, {med6} px, "
                             f"{n_pts} points, {n_faces} faces")
    if "pair-sharded matching" in log:
        raise AssertionError("I-6: 3 pairs for 4 ranks were matched sharded")
    rank0_alone_finished("I-6", log, reports, dense=True)
    launches["k2a"] = [rp["launches"]["sgm_bidir"] for rp in reports]
    ref6 = os.path.join(work, "out-w4-ref-insel")
    rc, _, _ = run_cli(["-Prun=photogrammetrie", f"-Presume={out6}/scene.npz", f"-Pout={ref6}",
                        *dense_flags, "--artifacts"], "chip_smoke_world4_ref_insel.log")
    if rc != 0:
        raise AssertionError(f"I-6 world-1 reference exited {rc}")
    depth_maps_equal(out6, ref6, 3, "I-6")
    files_equal(out6, ref6, ["pointcloud_dense.ply", "mesh_dense.ply"], "I-6")
    say(card, "I-6: 3 depth maps bit-equal, pointcloud_dense.ply and mesh_dense.ply identical "
              "to the world-1 run")
    return launches


def world4_sparse_limits(card: str, label: str, out: str, n_views: int, gt_R, gt_C,
                         ate_limit: float, rot_limit: float):
    """A sparse world-4 run's views, ATE, rotation and median reprojection
    against the limits; returns its scene."""
    scene, med = check_outputs(out)
    rec, rel_ate, rot = trajectory_error(scene, gt_R, gt_C)
    say(card, f"{label}: {len(rec)}/{n_views} views, ATE {rel_ate:.5%} of extent (limit "
              f"{ate_limit:.2%}), max rel rot {rot:.4f} deg (limit {rot_limit} deg), median "
              f"reprojection {med:.4f} px (limit 1 px)")
    if len(rec) != n_views or not (rel_ate <= ate_limit and rot <= rot_limit and med < 1.0):
        raise AssertionError(f"{label}: {len(rec)} views, ATE {rel_ate}, rot {rot}, reproj {med}")
    return scene


def world4_ba(card: str, scene_npz: str) -> dict:
    """I-2b: NCCL_WORLD4_BA under torchrun at world 4; returns rank 0's
    report."""
    script = os.path.join(os.path.dirname(scene_npz), "world4_ba.py")
    with open(script, "w") as f:
        f.write(NCCL_WORLD4_BA)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={WORLD4}", script, scene_npz]
    res = run_ranks(cmd, dict(os.environ, PYTHONPATH=ROOT), 300)
    with open(os.path.join(LOG_DIR, "chip_smoke_world4_ba.log"), "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise AssertionError(f"world-4 BA exited {res.returncode}:\n"
                             f"{(res.stdout + res.stderr)[-3000:]}")
    nccl_cards(res.stdout, WORLD4, "I-2b BA")
    r = json.loads(res.stdout.split("BA_REPORT ", 1)[1].splitlines()[0])
    for name in ("f64", "f32"):
        b = r[name]
        red, n_red = b["collectives"].get("collective all_reduce", (0.0, 0))
        say(card, f"I-2b sharded BA ({name}) on I-2's scene ({r['observations']} observations): "
                  f"cost {b['cost']!r} vs world 1 {b['ref_cost']!r} (rel {b['rel']:.3e}), "
                  f"{b['iterations']} iterations vs {b['ref_iterations']}, max |d| "
                  + ", ".join(f"{k} {v:.3e}" for k, v in b["max_abs"].items())
                  + f"; rank 0 wall {b['wall_s']:.3f} s, all_reduce {red:.4f} s x{n_red} "
                  f"({red / max(b['iterations'], 1) * 1e3:.3f} ms per LM iteration)")
    return r



# ------------------------------------------------------------- phase 17
# the mesh of one process: 17a two shards on card 0, 17b the four cards


def kernel_wrappers() -> tuple:
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import pm_kernel as K3
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import sgm_kernel as K2

    return (K.two_nn_batch_fused, K.two_nn_exact_batch, K2.sgm_bidir, K2.sgm_hpair,
            K2.sgm_dir_acc, K3.pm_score_rect)


def per_card(by_card: dict) -> str:
    return ", ".join(f"{k} " + "/".join(f"c{c}:{n}" for c, n in v.items())
                     for k, v in by_card.items() if v)


def walls_beside(label: str, wall: float, torchrun: str | None, world1: float | None) -> str:
    tr = TORCHRUN_WALLS.get(torchrun) if torchrun else None
    return (f"{label}: one-process wall {wall:.2f} s; torchrun world 4 ({torchrun}) "
            + (f"{tr:.2f} s" if tr is not None else "not run in this call")
            + "; world 1 " + (f"{world1:.2f} s" if world1 is not None else "not run"))


def mesh_run(card: str, label: str, argv: list[str], log_name: str, devices: str,
             kernels: list[str], idle_cards: tuple = ()) -> tuple[str, float, dict, dict]:
    """One CLI run in this process over the mesh -Pdevice=`devices`, under
    the stage timers, every kernel's counts zeroed just before and read just
    after. Each kernel in `kernels` must have launched on every card of the
    mesh but `idle_cards` (cards with no work), and on none of those.
    Returns (log, wall s, stage split, {kernel: {card: launches}})."""
    from sfm_mvs_pipeline_tpu_torch import resolve_devices
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import build
    from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

    wrappers = kernel_wrappers()
    build.reset_launches(*wrappers)
    stage_timer.enable()
    try:
        rc, log, wall = run_cli([*argv, f"-Pdevice={devices}"], log_name)
        split = stage_timer.report()
    finally:
        stage_timer.enable(False)
    if rc != 0:
        raise AssertionError(f"{label}: the CLI exited {rc}")
    by_card = {k.__name__: dict(sorted(k.by_card.items())) for k in wrappers}
    say(card, f"{label}: stages " + "; ".join(f"{k} {t:.3f} s x{n}" for k, (t, n) in split.items()))
    say(card, f"{label}: kernel launches per card " + per_card(by_card))
    cards = sorted({d.index for d in resolve_devices(devices) if d.type == "cuda"})
    for name in kernels:
        for c in cards:
            n = by_card[name].get(c, 0)
            if (n > 0) == (c in idle_cards):
                raise AssertionError(f"{label}: {name} launched {n} times on card {c} (cards "
                                     f"without work: {idle_cards})")
    return log, wall, split, by_card


def scenes_equal(out_a: str, out_b: str) -> bool:
    a = np.load(os.path.join(out_a, "scene.npz"))
    b = np.load(os.path.join(out_b, "scene.npz"))
    return set(a.files) == set(b.files) and all(np.array_equal(a[k], b[k]) for k in a.files)


def world1_twin(card: str, label: str, argv: list[str], mesh_out: str, twin_out: str,
                flags: list[str], n_views: int, log_name: str) -> float:
    """The mesh run's world-1 twin on one card: `argv` with -Pout=twin_out
    (from the same images, or resumed from the same scene.npz). Where its
    scene differs from the mesh run's (a sharded BA sums in another order),
    a world-1 run resumed from the mesh run's scene.npz with `flags` is the
    reference. Holds the depth maps bit-equal and pointcloud_dense.ply and
    mesh_dense.ply identical to the reference; returns the twin's wall."""
    rc, _, wall = run_cli([*argv, f"-Pout={twin_out}"], log_name)
    if rc != 0:
        raise AssertionError(f"{label} world-1 twin exited {rc}")
    if scenes_equal(mesh_out, twin_out):
        dense_equal(card, label, mesh_out, twin_out, n_views, "its world-1 twin from the same "
                    "input")
    else:
        resumed_reference(card, label, mesh_out, flags, n_views,
                          log_name.replace(".log", "_resumed.log"))
    return wall


def resumed_reference(card: str, label: str, mesh_out: str, flags: list[str], n_views: int,
                      log_name: str) -> None:
    """A world-1 run resumed from the mesh run's scene.npz with `flags`,
    its depth maps and dense files held to the mesh run's."""
    ref = mesh_out + "-w1-resumed"
    rc, _, _ = run_cli(["-Prun=photogrammetrie", f"-Presume={mesh_out}/scene.npz",
                        f"-Pout={ref}", *flags], log_name)
    if rc != 0:
        raise AssertionError(f"{label} world-1 reference exited {rc}")
    dense_equal(card, label, mesh_out, ref, n_views, "a world-1 run resumed from its scene.npz")


def dense_equal(card: str, label: str, out: str, ref: str, n_views: int, what: str) -> None:
    depth_maps_equal(out, ref, n_views, label)
    files_equal(out, ref, ["pointcloud_dense.ply", "mesh_dense.ply"], label)
    say(card, f"{label}: {n_views} depth maps bit-equal, pointcloud_dense.ply and mesh_dense.ply "
              f"identical to {what} on {ONE_CARD}")


def mesh_functions(card: str, label: str, scene_npz: str, devices: str) -> dict:
    """The sharded matcher (fast and exact) and BA (float64) over the mesh
    `devices` on a run's scene, against the one-device functions on the
    same inputs: the matcher bit-equal, BA within rel 1e-9 of the cost with
    the same iterations, and two BA runs bit-identical. Returns each
    kernel's launches per card in the sharded matcher."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.models.cameras import CAMERA_MODELS
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import build
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel as K
    from sfm_mvs_pipeline_tpu_torch.ops.matching import match_pairs_batch
    from sfm_mvs_pipeline_tpu_torch.ops.pairs import unordered_pairs
    from sfm_mvs_pipeline_tpu_torch.parallel.ba import run_bundle_adjustment_sharded
    from sfm_mvs_pipeline_tpu_torch.parallel.matching import match_pairs_sharded
    from sfm_mvs_pipeline_tpu_torch.sfm.ba import run_bundle_adjustment
    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene

    scene = load_scene(scene_npz)
    dev = torch.device(ONE_CARD)
    desc = torch.as_tensor(scene.descriptors, device=dev)
    valid = torch.as_tensor(scene.feat_valid, device=dev)
    pairs = torch.as_tensor(unordered_pairs(scene.n_shots), device=dev)
    launches = {}
    for exact, kern in ((False, K.two_nn_batch_fused), (True, K.two_nn_exact_batch)):
        build.reset_launches(kern)
        got = match_pairs_sharded(desc, valid, pairs, with_distance=True, exact=exact,
                                  device=devices)
        launches[kern.__name__] = dict(sorted(kern.by_card.items()))
        ref = match_pairs_batch(desc, valid, pairs, with_distance=True, exact=exact)
        if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, ref)):
            raise AssertionError(f"{label}: the sharded matcher (exact={exact}) differs from "
                                 "match_pairs_batch")
    imask = np.zeros((len(scene.intrinsics), 7))
    imask[:, list(CAMERA_MODELS[scene.camera_model].opt_mask)] = 1.0
    # the run's points moved off their optimum, so the LM takes real steps
    points = scene.points + np.random.default_rng(0).normal(size=scene.points.shape) * 1e-3
    args = (points, scene.poses, scene.intrinsics, scene.cam_of_shot, scene.obs_point,
            scene.obs_shot, scene.obs_uv.astype(np.float64), scene.obs_w.astype(np.float64),
            imask)
    kw = dict(pose_free=scene.recovered.astype(np.float64), dtype=torch.float64)
    ref = run_bundle_adjustment(*args, device=dev, **kw)
    t0 = time.perf_counter()
    runs = [run_bundle_adjustment_sharded(*args, device=devices, **kw) for _ in range(2)]
    ms = (time.perf_counter() - t0) / 2 * 1e3
    keys = ("points", "poses", "intrinsics")
    same = all(np.array_equal(runs[0][k], runs[1][k]) for k in keys)
    rel = abs(runs[0]["cost"] - ref["cost"]) / ref["cost"]
    max_abs = {k: float(np.abs(runs[0][k] - ref[k]).max()) for k in keys}
    say(card, f"{label}: sharded matcher (fast, exact) bit-equal to match_pairs_batch over "
              f"{devices}, launches per card {per_card(launches)}; sharded BA (float64, "
              f"{int((scene.obs_w > 0).sum())} observations) cost {runs[0]['cost']!r} vs one "
              f"device {ref['cost']!r} (rel {rel:.3e}, limit 1e-9), {runs[0]['iterations']} "
              f"iterations vs {ref['iterations']}, max |d| "
              + ", ".join(f"{k} {v:.3e}" for k, v in max_abs.items())
              + f", two runs bit-identical: {same}, {ms:.1f} ms a run")
    if not (rel <= 1e-9 and runs[0]["iterations"] == ref["iterations"] and same
            and runs[0]["cost"] == runs[1]["cost"]):
        raise AssertionError(f"{label}: sharded BA outside rel 1e-9 or not repeatable")
    return launches


def card_busy(*trace_paths: str) -> dict:
    """Each card's kernels in torch.profiler Chrome traces (one a process,
    each placed on the host's clock by its baseTimeNanoseconds) on one time
    axis: {"cards": {card: (first start s, last end s, busy s)} from the
    first kernel of the traces, "overlap_s": the time two or more cards
    were busy at once}."""
    spans: dict[int, list] = {}
    for path in trace_paths:
        with open(path) as f:
            trace = json.load(f)
        base = float(trace.get("baseTimeNanoseconds", 0)) / 1e3  # us, as ts
        for ev in trace["traceEvents"]:
            if ev.get("cat") == "kernel" and "dur" in ev:
                t = float(ev["ts"]) + base
                spans.setdefault(int(ev["args"]["device"]), []).append(
                    (t, t + float(ev["dur"])))
    if not spans:
        raise AssertionError(f"no kernel events in {trace_paths}")
    t0 = min(a for sp in spans.values() for a, _ in sp)
    cards, edges = {}, []
    for c, sp in sorted(spans.items()):
        sp.sort()
        merged = [list(sp[0])]
        for a, b in sp[1:]:
            if a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        cards[c] = ((merged[0][0] - t0) / 1e6, (merged[-1][1] - t0) / 1e6,
                    sum(b - a for a, b in merged) / 1e6)
        edges += [(a, 1) for a, _ in merged] + [(b, -1) for _, b in merged]
    busy, last, overlap = 0, None, 0.0
    for t, d in sorted(edges):
        if busy >= 2:
            overlap += t - last
        busy, last = busy + d, t
    return {"cards": cards, "overlap_s": overlap / 1e6}


def warm_mesh(card: str, work: str, label: str, devices: str) -> None:
    """Untimed, before a phase's first timed run: every sharded path once
    on every card of the mesh (parallel/dryrun.py) and insel's sparse SfM
    over it, so no timed run pays a card's first context, library load or
    first call of an op (a cold mesh run against its warm world-1 twin
    measures the cold start, not the mesh)."""
    from sfm_mvs_pipeline_tpu_torch.parallel.dryrun import dryrun_multichip
    from sfm_mvs_pipeline_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(devices)
    dryrun_multichip(len(mesh), devices=mesh)
    insel = os.path.join(ROOT, "sample_data", "insel")
    rc, _, _ = run_cli(["-Prun=photogrammetrie", f"-Pimage={insel}",
                        f"-Pout={os.path.join(work, f'out-{label}-warm')}", f"-Pdevice={devices}"],
                       f"chip_smoke_{label}_warm.log")
    if rc != 0:
        raise AssertionError(f"{label} warm-up exited {rc}")
    say(card, f"{label}: the mesh warmed (dryrun and insel's sparse SfM over {devices}) in "
              f"{time.perf_counter() - t0:.2f} s")


def phase_mesh_one_card(card: str, work: str, n_views=12, h=1080, w=1920, f=1680.0) -> dict:
    """17a: the mesh of two shards on one card (-Pdevice=cuda:0,cuda:0):
    the render with phase 7's flags, then PatchMatch resumed from its
    scene.npz, each held to its world-1 twin (world1_twin); then the
    sharded matcher and BA on that scene (mesh_functions). Returns each
    kernel's launches on the mesh paths."""
    return mesh_paths(card, work, "17a", f"{ONE_CARD},{ONE_CARD}", 2, n_views, h, w, f)


def mesh_paths(card: str, work: str, label: str, devices: str, n_shards: int, n_views: int,
               h: int, w: int, f: float) -> dict:
    """The render through the CLI over the mesh `devices` of n_shards
    shards: --sgm from the images (K1 pair-sharded, K2b view-sharded),
    then PatchMatch resumed (K3), each checked against phase 7's and 10's
    limits and held to its world-1 twin; then mesh_functions on its scene.
    Returns each kernel's launches per card."""
    data, gt_R, gt_C = render_once(card, work, n_views, h, w, f)
    warm_mesh(card, work, label, devices)
    dense = ["--dense", "--sgm", "--mesh", "--colored", "--artifacts"]
    out = os.path.join(work, f"out-{label}-sgm")
    argv = ["-Prun=photogrammetrie", f"-Pimage={data}", "-Pfeature-limit=0", *dense]
    log, wall, split, n = mesh_run(card, f"{label} --sgm", [*argv, f"-Pout={out}"],
                                   f"chip_smoke_{label}_sgm.log", devices,
                                   ["two_nn_batch_fused", "sgm_hpair", "sgm_dir_acc"])
    scene, med = check_outputs(out)
    rec, rel_ate, rot = trajectory_error(scene, gt_R, gt_C)
    share, n_pts = dense_accuracy(out, gt_R, gt_C)
    n_ba = len(re.findall(r"BA #\d+", log))
    n_sharded = log.count(f"point-sharded over {n_shards} devices")
    say(card, f"{label} --sgm: {len(rec)}/{n_views} views, ATE {rel_ate:.5%}, max rel rot "
              f"{rot:.4f} deg, median reprojection {med:.4f} px, {n_pts} dense points, "
              f"{share:.4%} within 1% of depth (limit {DENSE_SHARE_LIMIT:.0%}); {n_sharded} of "
              f"{n_ba} BA runs point-sharded; counts: {dense_counts(log)}")
    if len(rec) != n_views or not (rel_ate <= SIFT_ATE_LIMIT and rot <= 0.25 and med < 1.0):
        raise AssertionError(f"{label} --sgm: {len(rec)} views, ATE {rel_ate}, rot {rot}, {med}")
    if not share >= DENSE_SHARE_LIMIT:
        raise AssertionError(f"{label} --sgm: {share:.4%} of {n_pts} points on the surfaces")
    for what in (f"pair-sharded matching over {n_shards} devices",
                 f"view-sharded depth maps over {n_shards} devices",
                 *(f"c{i}/{n_shards} " for i in range(n_shards))):
        if what not in log:
            raise AssertionError(f"{label} --sgm: {what!r} not logged")
    if "dense real-size" in WORLD1_WALLS:  # phase 7 ran these flags from the images
        w1 = WORLD1_WALLS["dense real-size"]
        resumed_reference(card, f"{label} --sgm", out, dense, n_views,
                          f"chip_smoke_{label}_sgm_w1.log")
    else:
        w1 = world1_twin(card, f"{label} --sgm", argv, out, out + "-w1", dense, n_views,
                         f"chip_smoke_{label}_sgm_w1.log")
    say(card, walls_beside(f"{label} --sgm", wall, "I-2", w1))
    launches = {"k1": n["two_nn_batch_fused"],
                "k2b": {c: n["sgm_hpair"].get(c, 0) + n["sgm_dir_acc"].get(c, 0)
                        for c in n["sgm_hpair"]}}

    pm = ["--dense", "-Pdense-method=patchmatch", "--mesh", "--colored", "--artifacts"]
    out_pm = os.path.join(work, f"out-{label}-pm")
    argv = ["-Prun=photogrammetrie", f"-Presume={out}/scene.npz", *pm]
    log, wall, _, n = mesh_run(card, f"{label} PatchMatch", [*argv, f"-Pout={out_pm}"],
                               f"chip_smoke_{label}_pm.log", devices, ["pm_score_rect"])
    share, n_pts = dense_accuracy(out_pm, gt_R, gt_C)
    say(card, f"{label} PatchMatch: {n_pts} dense points, {share:.4%} within 1% of depth (limit "
              f"{PM_DENSE_SHARE_LIMIT:.0%}); counts: {dense_counts(log)}")
    if not share >= PM_DENSE_SHARE_LIMIT:
        raise AssertionError(f"{label} PatchMatch: {share:.4%} of {n_pts} points on the surfaces")
    w1 = world1_twin(card, f"{label} PatchMatch", argv, out_pm, out_pm + "-w1", pm, n_views,
                     f"chip_smoke_{label}_pm_w1.log")
    say(card, walls_beside(f"{label} PatchMatch", wall, "I-3", w1))
    launches["k3"] = n["pm_score_rect"]
    fn = mesh_functions(card, f"{label} functions", os.path.join(out, "scene.npz"), devices)
    launches["k1_function"] = fn["two_nn_batch_fused"]
    launches["k1x"] = fn["two_nn_exact_batch"]
    return launches


def phase_mesh_four_cards(card: str, work: str, n_views=12, h=1080, w=1920, f=1680.0,
                          devices: str = "cuda") -> dict:
    """17b: one process over the four cards (-Pdevice=cuda), phase 16's
    paths without torchrun: mesh_paths (the render --sgm, PatchMatch
    resumed, the sharded functions), a resumed --sgm run under
    -Pprofile= for each card's busy span on one time axis, exact (K1x),
    ORB at -Pfeature-limit=8192 (K1's bf16 route) and insel --sgm (K2a;
    3 views for 4 cards, card 3 idle). Each run's wall beside phase 16's
    torchrun wall and its world-1 twin's. Returns each kernel's launches
    per card."""
    import torch

    if devices == "cuda" and torch.cuda.device_count() < WORLD4:
        raise AssertionError(f"17b needs four cards; this machine has "
                             f"{torch.cuda.device_count()}")
    launches = mesh_paths(card, work, "17b", devices, WORLD4, n_views, h, w, f)
    data, gt_R, gt_C = render_once(card, work, n_views, h, w, f)

    # each card's busy span in the depth maps, from a torch.profiler trace
    prof = os.path.join(work, "prof-17b")
    out = os.path.join(work, "out-17b-prof")
    mesh_run(card, "17b profiled --sgm", ["-Prun=photogrammetrie",
             f"-Presume={work}/out-17b-sgm/scene.npz", f"-Pout={out}", "--dense", "--sgm",
             f"-Pprofile={prof}"], "chip_smoke_17b_profile.log", devices,
             ["sgm_hpair", "sgm_dir_acc"])
    busy = card_busy(os.path.join(prof, "trace.json"))
    say(card, "17b profiled --sgm (depth maps and fusion, no mesh): kernels per card on one "
              "time axis " + "; ".join(f"card {c} {a:.3f}-{b:.3f} s busy {t:.3f} s"
                                       for c, (a, b, t) in busy["cards"].items())
        + f"; two or more cards busy at once {busy['overlap_s']:.3f} s")

    for label, flags, kern, torchrun, limits in (
            ("17b exact", ["-Pfeature-limit=0", "-Pmatch-precision=exact"],
             "two_nn_exact_batch", "I-4", (SIFT_ATE_LIMIT, 0.25)),
            ("17b ORB", ["-Pfeature-detector=ORB", "-Pfeature-limit=8192"],
             "two_nn_batch_fused", "I-5", (ORB_ATE_LIMIT, ORB_ROT_LIMIT_DEG))):
        tag = label.split()[1].lower()
        out = os.path.join(work, f"out-17b-{tag}")
        argv = ["-Prun=photogrammetrie", f"-Pimage={data}", *flags, "--stats"]
        log, wall, split, n = mesh_run(card, label, [*argv, f"-Pout={out}"],
                                       f"chip_smoke_17b_{tag}.log", devices, [kern])
        if label == "17b exact" and any(n["two_nn_batch_fused"].values()):
            raise AssertionError("17b exact: K1 launched in exact mode")
        world4_sparse_limits(card, label, out, n_views, gt_R, gt_C, *limits)
        rc, _, w1 = run_cli([*argv, f"-Pout={out}-w1"], f"chip_smoke_17b_{tag}_w1.log")
        if rc != 0:
            raise AssertionError(f"{label} world-1 twin exited {rc}")
        say(card, walls_beside(label, wall, torchrun, w1)
            + f"; scene.npz written in the outputs stage's {split['outputs'][0]:.3f} s ("
            f"{os.path.getsize(os.path.join(out, 'scene.npz')) / 1e6:.1f} MB)")
        launches[{"17b exact": "k1x", "17b ORB": "k1_orb"}[label]] = n[kern]

    insel = os.path.join(ROOT, "sample_data", "insel")
    dense = ["--dense", "--sgm", "--mesh", "--colored", "--artifacts"]
    out = os.path.join(work, "out-17b-insel")
    argv = ["-Prun=photogrammetrie", f"-Pimage={insel}", *dense]
    log, wall, _, n = mesh_run(card, "17b insel --sgm", [*argv, f"-Pout={out}"],
                               "chip_smoke_17b_insel.log", devices, ["sgm_bidir"],
                               idle_cards=(3,))
    scene, med = check_outputs(out)
    if int(scene.recovered.sum()) != 3 or not med < 1.0 or "pair-sharded" in log:
        raise AssertionError(f"17b insel: {int(scene.recovered.sum())}/3 views, {med} px, or "
                             "3 pairs for 4 cards matched sharded")
    w1 = world1_twin(card, "17b insel --sgm", argv, out, out + "-w1", dense, 3,
                     "chip_smoke_17b_insel_w1.log")
    say(card, walls_beside("17b insel --sgm", wall, "I-6", w1))
    launches["k2a"] = n["sgm_bidir"]
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", help="comma-separated phases (default: 1-15 and 17, and 16 "
                    "on a machine with four cards)")
    ap.add_argument("--k1x-timing", metavar="ROOT",
                    help="only time K1x of the checkout at ROOT (see k1x_timing)")
    ap.add_argument("--k1x-inputs", metavar="NPZ", help="phase 14's saved K1x inputs, for "
                    f"--k1x-timing (phase 14 writes {os.path.relpath(K1X_PHASE14_INPUTS, ROOT)})")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    n_cards = torch.cuda.device_count()
    if args.phases:
        phases = {int(p) for p in args.phases.split(",")}
    else:
        phases = ALL_PHASES | ({FOUR_CARD_PHASE} if n_cards >= 4 else set())
    if FOUR_CARD_PHASE in phases and n_cards < 4:
        print(f"chip_smoke: phase {FOUR_CARD_PHASE} needs four cards; this machine has "
              f"{n_cards}", file=sys.stderr)
        return 1
    if args.k1x_timing:
        return k1x_timing(args.k1x_timing, args.k1x_inputs)
    sys.path.insert(0, ROOT)
    os.makedirs(LOG_DIR, exist_ok=True)
    open(os.path.join(LOG_DIR, "chip_smoke.log"), "w").close()  # say appends this run's lines
    card = card_line()
    print(card, flush=True)
    if FOUR_CARD_PHASE not in phases and not args.phases:
        say(card, f"phase {FOUR_CARD_PHASE} (the multi-device paths on four cards) needs four "
                  f"cards; this machine has {n_cards}: not run")
    from sfm_mvs_pipeline_tpu_torch import native
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import build, match_kernel, pm_kernel, sgm_kernel

    say(card, f"torch {torch.__version__} cuda {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    host = threading.Thread(target=native.available)  # g++, beside the nvcc processes
    host.start()
    build.build(match_kernel.SOURCE, match_kernel.EXACT_SOURCE, sgm_kernel.SOURCE,
                pm_kernel.SOURCE, verbose=True)
    host.join()
    if not native.available():
        raise AssertionError("the native host tier did not build")
    say(card, f"phase 1: K1, K1x, K2a, K2b, K3 and the native host tier built in "
              f"{time.perf_counter() - t0:.2f} s")
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
    k2b = {"name": "sgm_staged_hwd (sgm_hpair + sgm_dir_acc)", "route": "cuda", "source": K2_SOURCE,
           "replaces": K2B_REPLACES}
    k3 = {"name": "pm_score_rect", "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES}
    k1x = {"name": "two_nn_exact_batch", "route": "cuda", "source": K1X_SOURCE,
           "replaces": K1X_REPLACES}
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
    if 11 in phases:
        t0 = time.perf_counter()
        k1x.update(phase_exact_kernel(card))
        say(card, f"phase 11: {time.perf_counter() - t0:.2f} s")
    if 12 in phases:
        t0 = time.perf_counter()
        phase_orb_flann_insel(card)
        say(card, f"phase 12: {time.perf_counter() - t0:.2f} s")
    if 13 in phases:
        t0 = time.perf_counter()
        entry.setdefault("routes", {})["bf16_orb_run"] = phase_orb_real_size(card, work)
        say(card, f"phase 13: {time.perf_counter() - t0:.2f} s")
    if 14 in phases:
        t0 = time.perf_counter()
        k1x.update(phase_exact_real_size(card, work))
        say(card, f"phase 14: {time.perf_counter() - t0:.2f} s")
    if 15 in phases:
        t0 = time.perf_counter()
        w2 = phase_world2(card, work)
        n1 = phase_nccl_world1(card, work)
        # each rank's launches at world 2 (gloo), and world 1 on nccl
        entry["launches_world2"] = [r["two_nn_batch_fused"] for r in w2["sgm"]]
        k2b["launches_world2"] = [r["sgm_hpair"] + r["sgm_dir_acc"] for r in w2["sgm"]]
        k3["launches_world2"] = [r["pm_score_rect"] for r in w2["patchmatch"]]
        entry["launches_nccl_world1"] = n1["two_nn_batch_fused"]
        k1x["launches_nccl_world1"] = n1["two_nn_exact_batch"]
        k2b["launches_nccl_world1"] = n1["sgm_hpair"] + n1["sgm_dir_acc"]
        k3["launches_nccl_world1"] = n1["pm_score_rect"]
        say(card, f"phase 15: {time.perf_counter() - t0:.2f} s")
    four = torch.cuda.device_count() >= WORLD4
    if FOUR_CARD_PHASE in phases:
        t0 = time.perf_counter()
        w4 = phase_world4(card, work)
        # each rank's launches at world 4 on nccl (I-2, I-3, I-4, I-5, I-6)
        entry["launches_world4"] = w4["k1"]
        entry["launches_world4_orb"] = w4["k1_orb"]
        k1x["launches_world4"] = w4["k1x"]
        k2a["launches_world4"] = w4["k2a"]
        k2b["launches_world4"] = w4["k2b"]
        k3["launches_world4"] = w4["k3"]
        print(json.dumps({"launches_world4": w4}), flush=True)
        say(card, f"phase {FOUR_CARD_PHASE}: {time.perf_counter() - t0:.2f} s")
    if MESH_PHASE in phases:
        t0 = time.perf_counter()
        mesh = phase_mesh_four_cards(card, work) if four else phase_mesh_one_card(card, work)
        # each kernel's launches a card over the mesh (17a: two shards on card 0)
        key = "launches_mesh_4cards" if four else "launches_mesh_2shards"
        entry[key] = {"fp32": mesh["k1"], "bf16_orb": mesh.get("k1_orb")}
        k1x[key] = mesh["k1x"]
        k2b[key] = mesh["k2b"]
        k3[key] = mesh["k3"]
        if "k2a" in mesh:
            k2a[key] = mesh["k2a"]
        print(json.dumps({key: mesh}), flush=True)
        say(card, f"phase {MESH_PHASE} ({'17b' if four else '17a'}): "
                  f"{time.perf_counter() - t0:.2f} s")
    if not ALL_PHASES <= phases:
        print(f"partial run (phases {sorted(phases)}): every phase passed; no result line",
              flush=True)
        return 0
    for k in (entry, k2a, k2b, k3, k1x):
        k["library_ms"] = None  # no single PyTorch call computes any of these functions
    print(json.dumps({"kernels": [entry, k2a, k2b, k3, k1x]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
