"""The sharded paths in nccl groups on the card.

World 1 (one card): the pair-sharded matcher bit-equal to match_pairs_batch
(kernel K1, and K1x with exact=True) on the same inputs, so nccl's
all_gather carries the kernel's outputs unchanged. World 4 (four cards, one
rank a card, nccl by the backend rule): the matcher (fast and exact)
bit-equal to match_pairs_batch, the view-sharded depth maps (rect --sgm,
kernel K2a; PatchMatch, kernel K3) bit-equal to mvs/pipeline.py::
depth_map_view in a plain loop, and point-sharded BA (float64) within
tests/test_torch_parallel.py's world-4 tolerance of run_bundle_adjustment:
cost rel 1e-9, arrays 1e-7, the same iteration count. Rank 0 computes the
one-rank references on its card after leaving the group. Each case skips
below the cards it needs. This file imports no JAX, so on the card it runs
with

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py
"""

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import launch_ranks

_WORKER = r"""
import numpy as np
import torch
import torch.distributed as dist
from sfm_mvs_pipeline_tpu_torch.ops.matching import match_pairs_batch
from sfm_mvs_pipeline_tpu_torch.parallel.distributed import initialize_distributed
from sfm_mvs_pipeline_tpu_torch.parallel.matching import match_pairs_sharded

initialize_distributed()
assert dist.get_backend() == "nccl", dist.get_backend()
rng = np.random.default_rng(0)
S, F, D = 5, 300, 128
d = rng.integers(0, 256, size=(S, F, D)).astype(np.float32)
for s in range(S):  # duplicated rows: exact ties
    d[s, rng.integers(0, F, F // 8)] = d[s, rng.integers(0, F, F // 8)]
v = rng.random((S, F)) > 0.1
pairs = np.array([(a, b) for a in range(S) for b in range(a + 1, S)], np.int32)
dt, vt, pt = (torch.from_numpy(x).cuda() for x in (d, v, pairs))
for exact in (False, True):
    got = match_pairs_sharded(dt, vt, pt, with_distance=True, exact=exact)
    ref = match_pairs_batch(dt, vt, pt, with_distance=True, exact=exact)
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(got, ref)), exact
print("nccl world 1 OK", flush=True)
"""


@pytest.mark.gpu
def test_match_pairs_sharded_nccl_world1_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (out,) = launch_ranks(["-c", _WORKER], 1, timeout=300)
    assert "nccl world 1 OK" in out


_WORKER4 = r"""
import os
import numpy as np
import torch
import torch.distributed as dist
from sfm_mvs_pipeline_tpu_torch.mvs.pipeline import MVSConfig, depth_map_view
from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import make_depth_planes
from sfm_mvs_pipeline_tpu_torch.ops.kernels import match_kernel, pm_kernel, sgm_kernel
from sfm_mvs_pipeline_tpu_torch.ops.matching import match_pairs_batch
from sfm_mvs_pipeline_tpu_torch.parallel.ba import run_bundle_adjustment_sharded
from sfm_mvs_pipeline_tpu_torch.parallel.distributed import (
    initialize_distributed, shutdown_distributed)
from sfm_mvs_pipeline_tpu_torch.parallel.matching import match_pairs_sharded
from sfm_mvs_pipeline_tpu_torch.parallel.mvs import compute_depth_maps_sharded, fixed_neighbor_table
from sfm_mvs_pipeline_tpu_torch.sfm.ba import BAConfig, run_bundle_adjustment

initialize_distributed()
rank = dist.get_rank()
assert dist.get_backend() == "nccl" and dist.get_world_size() == 4, dist.get_backend()
dev = torch.device("cuda", torch.cuda.current_device())
assert dev.index == rank, (dev, rank)
rng = np.random.default_rng(0)

# matching: 7 shots (21 pairs, padded to 24), integers with ties
S, F, D = 7, 300, 128
d = rng.integers(0, 256, size=(S, F, D)).astype(np.float32)
for s in range(S):
    d[s, rng.integers(0, F, F // 8)] = d[s, rng.integers(0, F, F // 8)]
v = rng.random((S, F)) > 0.1
pairs = np.array([(a, b) for a in range(S) for b in range(a + 1, S)], np.int32)
dt, vt, pt = (torch.from_numpy(x).to(dev) for x in (d, v, pairs))
match = {x: [t.cpu() for t in match_pairs_sharded(dt, vt, pt, with_distance=True,
                                                  exact=x == "exact", device=dev)]
         for x in ("fast", "exact")}

# depth maps: a textured plane at depth 5 seen by 8 cameras along x
# (2 views a rank)
V, H, W, f = 8, 64, 96, 80.0
ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
grays = np.zeros((V, H, W), np.float32)
dposes = np.zeros((V, 6), np.float32)
for i in range(V):
    dposes[i, 3] = -0.2 * i
    X, Y = (xs - W / 2) / f * 5.0 + 0.2 * i, (ys - H / 2) / f * 5.0
    grays[i] = 0.5 + 0.25 * np.sin(9 * X + 3 * np.sin(5 * Y)) + 0.2 * np.sin(13 * Y - 4 * X)
dintr = np.array([f, W / 2, H / 2, 0, 0, 0, 0], np.float32)
nbr_idx, nbr_valid = fixed_neighbor_table(
    {i: [u for u in range(V) if u != i][:3] for i in range(V)}, list(range(V)), 3)
planes = np.stack([make_depth_planes(3.0, 8.0, 16).astype(np.float32)] * V)
CASES = {"rect_sgm": dict(method="rect", use_sgm=True),
         "patchmatch": dict(method="patchmatch", pm_iterations=4)}
for k in (sgm_kernel.sgm_bidir, pm_kernel.pm_score_rect):
    k.launches = 0
depth = {name: compute_depth_maps_sharded(grays, dposes, dintr, nbr_idx, nbr_valid, planes,
                                          window_radius=2, max_cost=0.5, device=dev, **kw)
         for name, kw in CASES.items()}
# every rank computed views of its own
assert sgm_kernel.sgm_bidir.launches > 0 and pm_kernel.pm_score_rect.launches > 0

# BA (float64): 8 shots around 600 points, 0.3 px noise
n_shots, n_pts = 8, 600
pts = rng.uniform(-2, 2, size=(n_pts, 3))
pts[:, 2] += 8
poses = np.zeros((n_shots, 6))
obs_p, obs_s, obs_uv = [], [], []
for s in range(n_shots):
    ang = (s - n_shots / 2) * 0.08
    poses[s] = [0, ang, 0, -np.sin(ang), 0, 8 - 8 * np.cos(ang)]
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    pc = pts @ R.T + poses[s][3:]
    sel = rng.random(n_pts) < 0.8
    obs_p.append(np.nonzero(sel)[0])
    obs_s.append(np.full(sel.sum(), s))
    obs_uv.append((pc[:, :2] / pc[:, 2:3] * 400.0 + [160, 120])[sel]
                  + rng.normal(size=(sel.sum(), 2)) * 0.3)
ba_args = (pts + rng.normal(size=pts.shape) * 0.02, poses + rng.normal(size=poses.shape) * 1e-3,
           np.array([[400.0, 160, 120, 0, 0, 0, 0]]), np.zeros(n_shots, np.int32),
           np.concatenate(obs_p).astype(np.int32), np.concatenate(obs_s).astype(np.int32),
           np.concatenate(obs_uv), np.ones(sum(len(o) for o in obs_p)),
           np.eye(1, 7))
ba_kw = dict(config=BAConfig(max_iterations=10), dtype=torch.float64, device=dev)
ba = run_bundle_adjustment_sharded(*ba_args, **ba_kw)
shutdown_distributed()

if rank == 0:  # the one-rank references on this card
    for x in ("fast", "exact"):
        ref = match_pairs_batch(dt, vt, pt, with_distance=True, exact=x == "exact")
        assert all(torch.equal(a, b.cpu()) for a, b in zip(match[x], ref)), x
    grays_d, poses_d = torch.as_tensor(grays, device=dev), torch.as_tensor(dposes, device=dev)
    intr_d = torch.as_tensor(dintr, device=dev)
    for name, kw in CASES.items():
        cfg = MVSConfig(n_neighbors=3, n_planes=16, window_radius=2, max_cost=0.5, **kw)
        for i in range(V):
            nbrs = [int(n) for n in nbr_idx[i][nbr_valid[i]]]
            dm, vm, _ = depth_map_view(cfg, i, nbrs, grays_d, dposes, poses_d, intr_d, f,
                                       float(planes[i].min()), float(planes[i].max()), W,
                                       planes=planes[i], max_disp=256)
            assert np.array_equal(depth[name][0][i], dm.cpu().numpy()), (name, i)
            assert np.array_equal(depth[name][1][i], vm.cpu().numpy()), (name, i)
        assert depth[name][1].mean() > 0.3, (name, depth[name][1].mean())
    ref = run_bundle_adjustment(*ba_args, **ba_kw)
    assert abs(ba["cost"] - ref["cost"]) <= 1e-9 * abs(ref["cost"]), (ba["cost"], ref["cost"])
    assert ba["iterations"] == ref["iterations"]
    for k in ("points", "poses", "intrinsics"):
        assert np.allclose(ba[k], ref[k], rtol=0, atol=1e-7), k
    assert np.sqrt(2 * ref["cost"] / len(ba_args[4])) < 0.5
print(f"nccl world 4 rank {rank} OK", flush=True)
"""


@pytest.mark.gpu
def test_sharded_paths_nccl_world4():
    """World 4 on four cards: matcher, depth maps and BA against the
    one-rank functions (see the module docstring)."""
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four CUDA cards, found {torch.cuda.device_count()}")
    outs = launch_ranks(["-c", _WORKER4], 4, timeout=200)
    for rank, out in enumerate(outs):
        assert f"nccl world 4 rank {rank} OK" in out
        assert f"r{rank}/4] process group: rank {rank} of 4, backend nccl" in out
    # each rank's card: "<index> GPU-<uuid>, PCI bus <bus>", four distinct cards
    cards = {out.split("this rank's card: ", 1)[1].split(")", 1)[0].split(" ", 1)[1]
             for out in outs}
    assert len(cards) == 4, cards
