"""One pass of every sharded path at toy shapes, over a mesh of one
process's devices or under torchrun.

The port's twin of the JAX package's __graft_entry__.dryrun_multichip:
pair-sharded matching (fast and exact), one LM step of point-sharded
bundle adjustment and view-sharded depth maps (sweep, rect, rect with SGM
and PatchMatch) over the shards: the devices of a mesh in one process
(as the JAX package's make_mesh(n_devices)), or the process group's
ranks, one device each. On the card it launches every kernel source (K1,
K1x, K2a, K3), so a first run builds each of them.

    python -m sfm_mvs_pipeline_tpu_torch.parallel.dryrun [--device cpu,cpu,cpu,cpu]
    python -m torch.distributed.run --standalone --nproc-per-node=2 \\
        -m sfm_mvs_pipeline_tpu_torch.parallel.dryrun [--device cpu]

The mesh prints one line a device, each rank one line, with the kernels'
launch counts, and the run exits 0 when every path ran and every result
has its shape and is finite.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run each sharded path once over n_devices shards: under torchrun the
    group's ranks (this process on `devices`, a resolve_devices spec such
    as "cpu"; default the rank's card); else the mesh `devices` (a Mesh or
    a resolve_devices spec; default the first n_devices visible cards),
    which must have n_devices devices."""
    from sfm_mvs_pipeline_tpu_torch.ops.pairs import unordered_pairs
    from sfm_mvs_pipeline_tpu_torch.parallel.ba import run_bundle_adjustment_sharded
    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards
    from sfm_mvs_pipeline_tpu_torch.parallel.matching import match_pairs_sharded
    from sfm_mvs_pipeline_tpu_torch.parallel.mesh import world
    from sfm_mvs_pipeline_tpu_torch.parallel.mvs import (
        compute_depth_maps_sharded,
        fixed_neighbor_table,
    )
    from sfm_mvs_pipeline_tpu_torch.sfm.ba import BAConfig

    shards = Shards(devices if devices is not None or world()[1] > 1 else n_devices)
    if shards.count != n_devices:
        raise RuntimeError(f"dryrun over {n_devices} shards on {shards.count} {shards.kind}")
    where = shards.mesh
    rng = np.random.default_rng(0)

    # --- pair-sharded matching
    S, F, D = 6, 64, 32
    descs = np.abs(rng.normal(size=(S, F, D))).astype(np.float32)
    valid = np.ones((S, F), bool)
    pairs = unordered_pairs(S)
    for exact in (False, True):  # kernel K1, and K1x
        idx, mask = match_pairs_sharded(descs, valid, pairs, exact=exact, device=where)
        if idx.shape != (len(pairs), F) or mask.shape != (len(pairs), F):
            raise AssertionError(f"sharded matching returned {tuple(idx.shape)}")

    # --- point-sharded bundle adjustment (one LM step)
    n_shots, n_pts = 6, 512
    f = 400.0
    pts = rng.uniform(-2, 2, size=(n_pts, 3))
    pts[:, 2] += 8
    poses = np.zeros((n_shots, 6))
    obs_p, obs_s, obs_uv = [], [], []
    for s in range(n_shots):
        ang = (s - n_shots / 2) * 0.1
        poses[s] = [0, ang, 0, -np.sin(ang), 0, 8 - 8 * np.cos(ang)]
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        pc = pts @ R.T + poses[s][3:]
        uv = pc[:, :2] / pc[:, 2:3] * f + [160, 120]
        sel = rng.random(n_pts) < 0.8
        obs_p.append(np.nonzero(sel)[0])
        obs_s.append(np.full(sel.sum(), s))
        obs_uv.append(uv[sel])
    obs_p = np.concatenate(obs_p).astype(np.int32)
    obs_s = np.concatenate(obs_s).astype(np.int32)
    obs_uv = np.concatenate(obs_uv)
    imask = np.zeros((1, 7))
    imask[0, 0] = 1.0
    out = run_bundle_adjustment_sharded(
        pts + rng.normal(size=pts.shape) * 0.02, poses, np.array([[f, 160, 120, 0, 0, 0, 0]]),
        np.zeros(n_shots, np.int32), obs_p, obs_s, obs_uv, np.ones(len(obs_p)), imask,
        config=BAConfig(max_iterations=1), device=where)
    if not np.isfinite(out["cost"]) or not np.isfinite(out["points"]).all():
        raise AssertionError(f"sharded BA cost {out['cost']}")

    # --- view-sharded depth maps, every engine
    V, H, W = 4, 24, 32
    grays = rng.random((V, H, W)).astype(np.float32)
    dposes = np.zeros((V, 6), np.float32)
    dposes[:, 3] = 0.1 * np.arange(V)
    dintr = np.array([30.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    nbrs = {v: [u for u in range(V) if u != v][:2] for v in range(V)}
    nbr_idx, nbr_valid = fixed_neighbor_table(nbrs, list(range(V)), 2)
    planes = np.tile(np.linspace(2.0, 6.0, 8, dtype=np.float32), (V, 1))
    cases = {"sweep": dict(method="sweep"), "rect": dict(method="rect"),
             "rect --sgm": dict(method="rect", use_sgm=True),  # kernel K2a
             "patchmatch": dict(method="patchmatch", pm_iterations=2)}  # kernel K3
    for name, kw in cases.items():
        dmaps, dvalid = compute_depth_maps_sharded(grays, dposes, dintr, nbr_idx, nbr_valid,
                                                   planes, window_radius=1, device=where, **kw)
        if dmaps.shape != (V, H, W) or not np.isfinite(dmaps).all():
            raise AssertionError(f"sharded {name} depth maps {dmaps.shape}")


def main() -> int:
    from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel, pm_kernel, sgm_kernel
    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import (
        initialize_distributed,
        process_count,
        process_index,
        shutdown_distributed,
    )
    from sfm_mvs_pipeline_tpu_torch.parallel.mesh import make_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="in one process the mesh, e.g. cuda:0,cuda:1 "
                    "or cpu,cpu,cpu,cpu (default every visible card); under torchrun the "
                    "rank's device: cpu, or its card (default)")
    args = ap.parse_args()
    kernels = (match_kernel.two_nn_batch_fused, match_kernel.two_nn_exact_batch,
               sgm_kernel.sgm_bidir, pm_kernel.pm_score_rect)
    # one write a line, as utils/logger.py does
    on_cpu = (args.device or "").lower().startswith("cpu")
    if not initialize_distributed(backend="gloo" if on_cpu else None):
        mesh = make_mesh(args.device)
        dryrun_multichip(len(mesh), devices=mesh)
        for i, dev in enumerate(mesh.devices):
            sys.stdout.write(f"dryrun device {i} of {len(mesh)} ({dev}): OK; kernel launches "
                             + ", ".join(f"{k.__name__} {k.by_card.get(dev.index, 0)}"
                                         for k in kernels) + "\n")
        sys.stdout.flush()
        return 0
    try:
        dryrun_multichip(process_count(), args.device)
        sys.stdout.write(f"dryrun rank {process_index()} of {process_count()}: OK; kernel "
                         "launches " + ", ".join(f"{k.__name__} {k.launches}" for k in kernels)
                         + "\n")
        sys.stdout.flush()
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
