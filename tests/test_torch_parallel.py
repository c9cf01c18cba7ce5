"""The port's sharded paths (parallel/) against its one-rank functions and
against the JAX package's sharded functions on the 8-device CPU mesh.

The port runs in real gloo process groups of 1, 2 and 4 ranks of one
device each, and as one process's mesh of four CPU devices ("mesh4":
-Pdevice=cpu,cpu,cpu,cpu in a group of one rank, so 4 shards, a thread
each) (one `python -c` worker a rank, one torch thread each, launched by
tests/test_torch_distributed.py::launch_ranks); the world-1 worker also
computes the one-rank references after leaving its group, so every
bit-equality compares runs with the same thread count. Inputs are made
from seeds with numpy: 6 shots x 128 features (15 pairs: padded to 16 at
world 2 and 4), tests/test_parallel.py's _ba_problem, and
tests/test_parallel_mvs.py's camera ring.

Tolerances:
  * matching: bit-equal to match_pairs_batch at every world size; against
    the JAX package on integer descriptors, idx at valid queries and masks
    equal.
  * BA (float64): world 1 bit-equal to run_bundle_adjustment; worlds 2, 4
    and mesh4 sum in another order: cost within rel 1e-9 and arrays within
    1e-7 of it, the same iteration count. Against the JAX package's
    sharded BA (its fused dense LM, x64): cost rel 1e-6, poses 1e-6,
    points 1e-5.
  * depth maps: world 1 bit-equal to mvs/pipeline.py::depth_map_view
    called for each view in a plain loop, and every shape bit-equal to
    world 1 (sweep, rect, rect + SGM, PatchMatch). Against the JAX package's sharded sweep, rect
    and rect + SGM: where both are valid, the median relative depth
    difference <= 1e-4 and the valid masks agree on >= 98% of the pixels.
  * mesh4 against world 4 (the same shard count): matching and depth maps
    bit-equal; against the JAX package's sharded functions on make_mesh(4)
    (4 of the 8 virtual CPU devices) with the tolerances above.
"""

import os

import numpy as np
import pytest

from tests.test_parallel import _ba_problem
from tests.test_parallel_mvs import _camera_ring
from tests.test_torch_distributed import launch_ranks

WORLDS = (1, 2, 4)
# a run's shape: (ranks, -Pdevice= of each rank); "mesh4" is one process's
# mesh of four devices
SHAPES = {1: (1, "cpu"), 2: (2, "cpu"), 4: (4, "cpu"), "mesh4": (1, "cpu,cpu,cpu,cpu")}
DEPTH_CASES = {"sweep": dict(method="sweep"), "rect": dict(method="rect"),
               "rect_sgm": dict(method="rect", use_sgm=True),
               "patchmatch": dict(method="patchmatch", pm_iterations=5)}
BA_ITERS = 10

_WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from sfm_mvs_pipeline_tpu_torch.parallel.distributed import initialize_distributed, shutdown_distributed
from sfm_mvs_pipeline_tpu_torch.parallel.ba import run_bundle_adjustment_sharded
from sfm_mvs_pipeline_tpu_torch.parallel.matching import match_pairs_sharded
from sfm_mvs_pipeline_tpu_torch.parallel.mvs import compute_depth_maps_sharded
from sfm_mvs_pipeline_tpu_torch.ops.matching import match_pairs_batch
from sfm_mvs_pipeline_tpu_torch.sfm.ba import BAConfig, run_bundle_adjustment

CASES = %(cases)r
DEVICES = os.environ["DEVICES"]
SHAPE = os.environ["SHAPE"]
z = dict(np.load(os.environ["INPUTS"]))
rank = int(os.environ["RANK"])
initialize_distributed()


def match_pairs_batch_np(desc, valid, pairs, **kw):
    return match_pairs_batch(torch.as_tensor(desc), torch.as_tensor(valid),
                             torch.as_tensor(pairs), **kw)


def run(prefix, match, ba, depth):
    out = {}
    for name in ("f", "i"):
        res = match(z["desc_" + name], z["valid_" + name], z["pairs"], with_distance=True)
        for k, r in zip(("idx", "mask", "dist"), res):
            out[f"{prefix}match_{name}_{k}"] = torch.as_tensor(r).numpy()
    idx, mask = match(z["desc_i"], z["valid_i"], z["pairs"], exact=True)
    out[prefix + "match_x_idx"], out[prefix + "match_x_mask"] = idx.numpy(), mask.numpy()
    for layout in ("dense", "track"):
        o = ba(*(z[f"ba_{layout}_{k}"] for k in ("pts", "poses", "intr", "cams", "op", "os",
                                                 "ouv", "ow", "imask")),
               config=BAConfig(max_iterations=%(iters)d), dtype=torch.float64, device=DEVICES)
        for k in ("points", "poses", "intrinsics", "cost", "iterations", "table_kind"):
            out[f"{prefix}ba_{layout}_{k}"] = np.asarray(o[k])
    if depth:
        for name, kw in CASES.items():
            d, v = compute_depth_maps_sharded(z["grays"], z["dposes"], z["dintr"], z["nbr_idx"],
                                              z["nbr_valid"], z["planes"], window_radius=2,
                                              max_cost=0.5, device=DEVICES, **kw)
            out[f"{prefix}depth_{name}"], out[f"{prefix}valid_{name}"] = d, v
    return out


# the one-rank depth reference: mvs/pipeline.py::depth_map_view over the
# views in a plain loop, with compute_depth_maps_sharded's defaults
def depth_per_view(**kw):
    from sfm_mvs_pipeline_tpu_torch.mvs.pipeline import MVSConfig, depth_map_view

    V, H, W = z["grays"].shape
    planes = z["planes"].astype(np.float32)
    cfg = MVSConfig(n_neighbors=z["nbr_idx"].shape[1], n_planes=planes.shape[1],
                    window_radius=2, max_cost=0.5, **kw)
    poses = z["dposes"].astype(np.float32)
    grays_d, poses_d = torch.as_tensor(z["grays"]), torch.as_tensor(poses)
    intr_d = torch.as_tensor(z["dintr"].astype(np.float32))
    depth, valid = np.zeros((V, H, W), np.float32), np.zeros((V, H, W), bool)
    for i in range(V):
        nbrs = [int(n) for n in z["nbr_idx"][i][z["nbr_valid"][i]]]
        d, v, _ = depth_map_view(cfg, i, nbrs, grays_d, poses, poses_d, intr_d,
                                 float(z["dintr"][0]), float(planes[i].min()),
                                 float(planes[i].max()), W, planes=planes[i], max_disp=256)
        depth[i], valid[i] = d.numpy(), v.numpy()
    return depth, valid


out = run("", lambda *a, **k: match_pairs_sharded(*a, device=DEVICES, **k),
          run_bundle_adjustment_sharded, True)
shutdown_distributed()
if SHAPE == "1":  # the one-rank references, same thread count
    out.update(run("ref_", match_pairs_batch_np, run_bundle_adjustment, False))
    for name, kw in CASES.items():
        out["ref_depth_" + name], out["ref_valid_" + name] = depth_per_view(**kw)
np.savez(os.environ["OUT"] %% rank, **out)
print(f"rank {rank} OK", flush=True)
"""

def _inputs():
    from sfm_mvs_pipeline_tpu.ops.pairs import unordered_pairs
    from sfm_mvs_pipeline_tpu.mvs.plane_sweep import make_depth_planes
    from sfm_mvs_pipeline_tpu.parallel.mvs import fixed_neighbor_table

    rng = np.random.default_rng(42)
    S, F, D = 6, 128, 32
    z = {"pairs": unordered_pairs(S).astype(np.int32)}
    # every shot sees one table of features, shuffled and perturbed, so the
    # ratio test keeps matches
    base = np.abs(rng.normal(size=(F, D)))
    z["desc_f"] = np.stack([base[rng.permutation(F)] + 0.1 * rng.normal(size=(F, D))
                            for _ in range(S)]).astype(np.float32)
    z["valid_f"] = np.ones((S, F), bool)
    # small integers: exact distances, and duplicated rows so distances tie
    # (the lowest index wins); ~10% of the slots invalid
    base = rng.integers(0, 16, size=(F, D))
    desc_i = np.stack([base[rng.permutation(F)] + rng.integers(0, 2, size=(F, D))
                       for _ in range(S)]).astype(np.float32)
    for s in range(S):
        desc_i[s, rng.integers(0, F, size=F // 8)] = desc_i[s, rng.integers(0, F, size=F // 8)]
    z["desc_i"] = desc_i
    z["valid_i"] = rng.random((S, F)) > 0.1
    pts, poses, intr, op, osr, ouv = _ba_problem(np.random.default_rng(42))
    imask = np.zeros((1, 7))
    imask[0, 0] = 1.0
    ba = dict(pts=pts, poses=poses, intr=intr, cams=np.zeros(len(poses), np.int32), op=op,
              os=osr, ouv=ouv, ow=np.ones(len(op)), imask=imask)
    for k, v in ba.items():
        z[f"ba_dense_{k}"] = v
        z[f"ba_track_{k}"] = v
    # a point observed twice in one shot forces the track layout
    z["ba_track_op"] = np.concatenate([op, op[:1]])
    z["ba_track_os"] = np.concatenate([osr, osr[:1]])
    z["ba_track_ouv"] = np.concatenate([ouv, ouv[:1] + 0.5])
    z["ba_track_ow"] = np.ones(len(op) + 1)
    grays, dposes, dintr = _camera_ring(np.random.default_rng(42))
    V = len(grays)
    z.update(grays=grays, dposes=dposes, dintr=dintr)
    z["planes"] = np.stack([np.asarray(make_depth_planes(3.0, 8.0, 16), np.float32)] * V)
    neighbors = {v: [u for u in range(V) if u != v][:3] for v in range(V)}
    z["nbr_idx"], z["nbr_valid"] = fixed_neighbor_table(neighbors, list(range(V)), 3)
    return z


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{shape: [rank outputs]} of the worker at each shape (SHAPES), and
    the inputs."""
    tmp = tmp_path_factory.mktemp("parallel")
    z = _inputs()
    np.savez(tmp / "inputs.npz", **z)
    script = _WORKER % {"cases": DEPTH_CASES, "iters": BA_ITERS}
    res = {}
    for shape, (ranks, devices) in SHAPES.items():
        pattern = str(tmp / f"w{shape}_r%d.npz")
        launch_ranks(["-c", script], ranks, env={"INPUTS": str(tmp / "inputs.npz"),
                                                 "OUT": pattern, "DEVICES": devices,
                                                 "SHAPE": str(shape)}, timeout=180)
        res[shape] = [dict(np.load(pattern % r)) for r in range(ranks)]
    return res, z


def test_every_rank_returns_the_same_bits(runs):
    res, _ = runs
    for world in list(SHAPES)[1:]:
        for rank in range(1, len(res[world])):
            for k, v in res[world][0].items():
                np.testing.assert_array_equal(res[world][rank][k], v, err_msg=f"{world} {k}")


@pytest.mark.parametrize("world", list(SHAPES))
def test_sharded_matching_equals_match_pairs_batch(runs, world):
    res, _ = runs
    got, ref = res[world][0], res[1][0]
    for k in ("f_idx", "f_mask", "f_dist", "i_idx", "i_mask", "i_dist", "x_idx", "x_mask"):
        np.testing.assert_array_equal(got["match_" + k], ref["ref_match_" + k], err_msg=k)
    assert got["match_f_mask"].shape == (15, 128)
    assert got["match_f_mask"].mean() > 0.5 and got["match_i_mask"].mean() > 0.3


def test_sharded_matching_vs_jax(runs):
    """Integer descriptors: the JAX package's sharded matcher (jnp backend,
    8 devices) gives the same idx at every valid query and the same masks."""
    from sfm_mvs_pipeline_tpu.parallel.matching import match_pairs_sharded as j_match
    from sfm_mvs_pipeline_tpu.parallel.mesh import make_mesh

    res, z = runs
    idx_j, mask_j = j_match(make_mesh(), z["desc_i"], z["valid_i"], z["pairs"], backend="jnp")
    vq = z["valid_i"][z["pairs"][:, 0]]
    for world in WORLDS[1:]:
        got = res[world][0]
        np.testing.assert_array_equal(got["match_i_mask"], np.asarray(mask_j))
        np.testing.assert_array_equal(got["match_i_idx"][vq], np.asarray(idx_j)[vq])


@pytest.mark.parametrize("n_shots", [None, 8], ids=["track", "dense"])
def test_shard_scene_by_points_vs_jax(n_shots):
    """The JAX package's shards, up to the order of each shard's
    observations: the port keeps the input order, the JAX package sorts by
    point (a stable sort of the port's shard gives the JAX shard)."""
    from sfm_mvs_pipeline_tpu.parallel.ba import shard_scene_by_points as j_shard
    from sfm_mvs_pipeline_tpu_torch.parallel.ba import shard_scene_by_points as t_shard

    pts, poses, intr, op, osr, ouv = _ba_problem(np.random.default_rng(42))
    ow = np.ones(len(op))
    sj = j_shard(4, pts, op, osr, ouv, ow, n_shots=n_shots)
    st = t_shard(4, pts, op, osr, ouv, ow, n_shots=n_shots)
    assert st["table_kind"] == sj["table_kind"] == ("dense" if n_shots else "track")
    np.testing.assert_array_equal(st["points"], sj["points"])
    np.testing.assert_array_equal(st["point_ids"], sj["point_ids"])
    for d in range(4):
        n = int(st["n_obs"][d])
        perm = np.argsort(st["obs_point"][d][:n], kind="stable")
        for k in ("obs_point", "obs_shot", "obs_uv", "obs_w"):
            np.testing.assert_array_equal(st[k][d][:n][perm], sj[k][d][:n], err_msg=k)
            assert not sj[k][d][n:].any() and not st[k][d][n:].any()
        if n_shots:
            np.testing.assert_array_equal(st["uv_ps"][d], sj["uv_ps"][d])
            np.testing.assert_array_equal(st["w_ps"][d], sj["w_ps"][d])
        else:
            inv = np.empty(n, np.int64)
            inv[perm] = np.arange(n)
            tab = st["track_tab"][d]
            mapped = np.where(tab >= 0, inv[np.maximum(tab, 0)], -1)
            np.testing.assert_array_equal(mapped, sj["track_tab"][d])


@pytest.mark.parametrize("layout", ["dense", "track"])
def test_sharded_ba_world1_bit_equal(runs, layout):
    got = runs[0][1][0]
    assert got[f"ba_{layout}_table_kind"] == layout
    for k in ("points", "poses", "intrinsics", "cost", "iterations"):
        np.testing.assert_array_equal(got[f"ba_{layout}_{k}"], got[f"ref_ba_{layout}_{k}"], k)


@pytest.mark.parametrize("world", list(SHAPES)[1:])
@pytest.mark.parametrize("layout", ["dense", "track"])
def test_sharded_ba_within_tolerance(runs, world, layout):
    res, z = runs
    got, ref = res[world][0], res[1][0]
    cost = float(ref[f"ref_ba_{layout}_cost"])
    assert float(got[f"ba_{layout}_cost"]) == pytest.approx(cost, rel=1e-9)
    assert int(got[f"ba_{layout}_iterations"]) == int(ref[f"ref_ba_{layout}_iterations"])
    for k in ("points", "poses", "intrinsics"):
        np.testing.assert_allclose(got[f"ba_{layout}_{k}"], ref[f"ref_ba_{layout}_{k}"],
                                   atol=1e-7, err_msg=k)
    n_obs = len(z[f"ba_{layout}_op"])
    assert np.sqrt(2 * cost / n_obs) < 0.5  # 0.3 px noise, recovered


def test_sharded_ba_vs_jax(runs):
    from sfm_mvs_pipeline_tpu.parallel.ba import run_bundle_adjustment_sharded as j_ba
    from sfm_mvs_pipeline_tpu.parallel.mesh import make_mesh
    from sfm_mvs_pipeline_tpu.sfm.ba import BAConfig as JConfig

    res, z = runs
    args = [z[f"ba_dense_{k}"] for k in ("pts", "poses", "intr", "cams", "op", "os", "ouv",
                                         "ow", "imask")]
    oj = j_ba(make_mesh(), *args, config=JConfig(max_iterations=BA_ITERS))
    for world in WORLDS[1:]:
        got = res[world][0]
        assert float(got["ba_dense_cost"]) == pytest.approx(oj["cost"], rel=1e-6)
        np.testing.assert_allclose(got["ba_dense_poses"], oj["poses"], atol=1e-6)
        np.testing.assert_allclose(got["ba_dense_points"], oj["points"], atol=1e-5)


@pytest.mark.parametrize("world", list(SHAPES)[1:])
@pytest.mark.parametrize("case", list(DEPTH_CASES))
def test_sharded_depth_maps_bit_equal_to_world1(runs, world, case):
    res, _ = runs
    got, ref = res[world][0], res[1][0]
    np.testing.assert_array_equal(got["depth_" + case], ref["depth_" + case])
    np.testing.assert_array_equal(got["valid_" + case], ref["valid_" + case])
    assert got["valid_" + case].mean() > 0.3
    assert abs(np.median(got["depth_" + case][got["valid_" + case]]) - 5.0) < 0.5


@pytest.mark.parametrize("case", list(DEPTH_CASES))
def test_sharded_depth_maps_world1_equal_per_view_loop(runs, case):
    """World 1 against the one-rank path itself: depth_map_view called for
    each view in a plain loop, outside any process group."""
    res, _ = runs
    got = res[1][0]
    np.testing.assert_array_equal(got["depth_" + case], got["ref_depth_" + case])
    np.testing.assert_array_equal(got["valid_" + case], got["ref_valid_" + case])


@pytest.mark.parametrize("case", ["sweep", "rect", "rect_sgm"])
def test_sharded_depth_maps_vs_jax(runs, case):
    from sfm_mvs_pipeline_tpu.parallel.mesh import make_mesh
    from sfm_mvs_pipeline_tpu.parallel.mvs import compute_depth_maps_sharded as j_depth

    res, z = runs
    kw = dict(DEPTH_CASES[case])
    d_j, v_j = j_depth(make_mesh(), z["grays"], z["dposes"], z["dintr"], z["nbr_idx"],
                       z["nbr_valid"], z["planes"], window_radius=2, max_cost=0.5, **kw)
    d_t, v_t = res[2][0]["depth_" + case], res[2][0]["valid_" + case]
    d_j, v_j = np.asarray(d_j), np.asarray(v_j)
    both = v_t & v_j
    assert both.mean() > 0.3
    rel = np.abs(d_t - d_j)[both] / d_j[both]
    assert np.median(rel) <= 1e-4, np.median(rel)
    assert (v_t == v_j).mean() >= 0.98, (v_t == v_j).mean()


@pytest.mark.parametrize("what", ["match", *DEPTH_CASES])
def test_mesh_bit_equal_to_world4(runs, what):
    """A mesh of 4 devices is 4 shards, a thread each: the same blocks of
    pairs and views as 4 ranks of one device, so the same bits."""
    res, _ = runs
    got, ref = res["mesh4"][0], res[4][0]
    keys = [k for k in ref if k.startswith("match_")] if what == "match" else [
        "depth_" + what, "valid_" + what]
    for k in keys:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("what", ["match", "ba", "sweep", "rect", "rect_sgm"])
def test_mesh_vs_jax_mesh4(runs, what):
    """The port's mesh of 4 devices against the JAX package's sharded
    functions on make_mesh(4): the same shard count."""
    from sfm_mvs_pipeline_tpu.parallel.mesh import make_mesh

    res, z = runs
    got, mesh = res["mesh4"][0], make_mesh(4)
    if what == "match":
        from sfm_mvs_pipeline_tpu.parallel.matching import match_pairs_sharded as j_match

        idx_j, mask_j = j_match(mesh, z["desc_i"], z["valid_i"], z["pairs"], backend="jnp")
        vq = z["valid_i"][z["pairs"][:, 0]]
        np.testing.assert_array_equal(got["match_i_mask"], np.asarray(mask_j))
        np.testing.assert_array_equal(got["match_i_idx"][vq], np.asarray(idx_j)[vq])
    elif what == "ba":
        from sfm_mvs_pipeline_tpu.parallel.ba import run_bundle_adjustment_sharded as j_ba
        from sfm_mvs_pipeline_tpu.sfm.ba import BAConfig as JConfig

        args = [z[f"ba_dense_{k}"] for k in ("pts", "poses", "intr", "cams", "op", "os", "ouv",
                                             "ow", "imask")]
        oj = j_ba(mesh, *args, config=JConfig(max_iterations=BA_ITERS))
        assert float(got["ba_dense_cost"]) == pytest.approx(oj["cost"], rel=1e-6)
        np.testing.assert_allclose(got["ba_dense_poses"], oj["poses"], atol=1e-6)
        np.testing.assert_allclose(got["ba_dense_points"], oj["points"], atol=1e-5)
    else:
        from sfm_mvs_pipeline_tpu.parallel.mvs import compute_depth_maps_sharded as j_depth

        d_j, v_j = j_depth(mesh, z["grays"], z["dposes"], z["dintr"], z["nbr_idx"],
                           z["nbr_valid"], z["planes"], window_radius=2, max_cost=0.5,
                           **DEPTH_CASES[what])
        d_t, v_t = got["depth_" + what], got["valid_" + what]
        d_j, v_j = np.asarray(d_j), np.asarray(v_j)
        both = v_t & v_j
        assert both.mean() > 0.3
        assert np.median(np.abs(d_t - d_j)[both] / d_j[both]) <= 1e-4
        assert (v_t == v_j).mean() >= 0.98, (v_t == v_j).mean()


def test_lm_solve_reduce_hook_is_exact():
    """The build/reduce split: summing the flat buffer of undamped terms
    with an identity reduce gives the one-rank numbers bit for bit."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.sfm import ba as B

    pts, poses, intr, op, osr, ouv = _ba_problem(np.random.default_rng(3), S=5, P=300)
    ow = np.ones(len(op))
    imask = np.zeros((1, 7))
    imask[0, 0] = 1.0
    grid = B.pack_dense_obs(op, osr, ouv, ow, len(pts), len(poses))
    tab = B.build_track_table(op, ow, len(pts))
    cams = np.zeros(len(poses), np.int32)
    for g, t in ((grid, None), (None, tab)):
        outs = [B.lm_solve(pts, poses, intr, cams, op, osr, ouv, ow, imask, None, g, t,
                           B.BAConfig(max_iterations=5), torch.float64, torch.device("cpu"),
                           reduce=red) for red in (None, lambda x: x.clone())]
        (*tensors_a, it_a, conv_a, lam_a, kind_a), (*tensors_b, it_b, conv_b, lam_b, kind_b) = outs
        for a, b in zip(tensors_a + [conv_a, lam_a], tensors_b + [conv_b, lam_b]):
            assert torch.equal(a, b)
        assert (it_a, kind_a) == (it_b, kind_b)
