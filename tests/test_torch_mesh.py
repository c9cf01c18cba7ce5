"""The port's one-process device mesh (parallel/mesh.py, Shards in
parallel/distributed.py) on the CPU: a mesh of "cpu,cpu,cpu,cpu", the
counterpart of the JAX tests' forced host device count.

Inputs are made from seeds with numpy. Everything runs with one torch
thread (the fixture below), in this process: the mesh's shards are
threads.

Tolerances:
  * resolve_devices: the list forms exactly; "cuda" and torch.device("cuda")
    alike; no card, a card that does not exist, a mesh that mixes the CPU
    and cards, and inside a process group of more than one rank a list,
    another card than the rank's or the CPU under nccl raise; the one
    card a rank takes (LOCAL_RANK % device_count): its own (phase 16's
    shape) or one the ranks share (phase 15's).
  * matching: bit-equal to match_pairs_batch, and to the JAX package's
    match_pairs_sharded on its make_mesh(4) (jnp backend) on integer
    descriptors (idx at valid queries, masks, distances), fast and exact.
  * BA (float64): cost within rel 1e-9 and arrays within 1e-7 of the
    one-device BA, the same iterations; against the JAX package's sharded
    BA on 4 devices tests/test_torch_parallel.py's tolerances (cost rel
    1e-6, poses 1e-6, points 1e-5); two runs bit-identical.
  * the CLI with -Pdevice=cpu,cpu,cpu,cpu: depth maps bit-equal and
    pointcloud_dense.ply / mesh_dense.ply byte-identical to -Pdevice=cpu
    resumed from the same scene.npz (--sgm, then PatchMatch), on insel (3
    views for 4 shards) and a 5-view render (2, 2, 1 and 0 views a shard);
    a mesh's sparse SfM leaves BA unsharded past the gate, its scene.npz
    identical to -Pdevice=cpu.
  * stage timers in a mesh: a stage's total is its longest shard's.
"""

import filecmp
import os
import threading

import numpy as np
import pytest
import torch

from tests.test_parallel import _ba_problem
from tests.test_torch_distributed import INSEL, free_port

BA_ITERS = 10


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def four_cards(monkeypatch):
    """torch as on a machine with four cards, current card 2 (nothing is
    allocated on them)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)


# ----------------------------------------------------------- resolve_devices


@pytest.mark.parametrize("spec, want", [
    ("cpu", ["cpu"]),
    ("cpu,cpu,cpu,cpu", ["cpu"] * 4),
    (" CPU , cpu ", ["cpu"] * 2),
    (["cpu", torch.device("cpu")], ["cpu"] * 2),
    (torch.device("cpu"), ["cpu"]),
])
def test_resolve_devices_lists(spec, want):
    from sfm_mvs_pipeline_tpu_torch import resolve_devices
    from sfm_mvs_pipeline_tpu_torch.parallel.mesh import make_mesh

    assert resolve_devices(spec) == tuple(torch.device(d) for d in want)
    mesh = make_mesh(spec)
    assert len(mesh) == len(want) and mesh.first == torch.device("cpu")


def test_resolve_devices_cards(four_cards):
    from sfm_mvs_pipeline_tpu_torch import resolve_devices
    from sfm_mvs_pipeline_tpu_torch.parallel.mesh import make_mesh

    every = tuple(torch.device("cuda", i) for i in range(4))
    assert resolve_devices(None) == resolve_devices("cuda") == every
    assert resolve_devices(torch.device("cuda")) == every
    assert resolve_devices("cuda:0,cuda:0") == (torch.device("cuda", 0),) * 2
    assert resolve_devices("cuda:3,cuda:1") == (torch.device("cuda", 3), torch.device("cuda", 1))
    assert make_mesh(2).devices == every[:2]
    for bad in ("cuda:4", "cuda:0,cuda:7"):
        with pytest.raises(RuntimeError, match="no card cuda:"):
            resolve_devices(bad)
    with pytest.raises(RuntimeError, match="a mesh of 5 devices"):
        make_mesh(5)
    with pytest.raises(ValueError, match="unknown device"):
        resolve_devices("mps")
    for mixed in ("cpu,cuda:0", ["cuda:1", "cpu"]):
        with pytest.raises(ValueError, match="a mesh mixes the CPU and cards"):
            resolve_devices(mixed)


def test_resolve_devices_without_a_card():
    from sfm_mvs_pipeline_tpu_torch import resolve_devices

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for spec in (None, "cuda", "cuda:0", "cpu,cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_devices(spec)


@pytest.fixture
def gloo_group():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_default_under_a_process_group_is_the_ranks_card(gloo_group, four_cards, monkeypatch):
    """In a process group of two ranks (the size a stand-in) made without
    initialize_distributed the default is the rank's current card; a
    device named must be it, or the CPU under gloo; a list of several
    devices raises, naming the mesh instead; another card, a mesh that
    mixes the CPU and cards, and the CPU under nccl raise."""
    import torch.distributed as dist

    from sfm_mvs_pipeline_tpu_torch import resolve_devices
    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards

    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    own = (torch.device("cuda", 2),)
    assert resolve_devices(None) == resolve_devices("cuda") == own
    assert resolve_devices(torch.device("cuda")) == resolve_devices("cuda:2") == own
    assert resolve_devices("cpu") == (torch.device("cpu"),)
    for spec in ("cpu,cpu", "cuda:2,cuda:2", "cuda:0,cuda:1", ["cpu", "cpu", "cpu"]):
        with pytest.raises(RuntimeError, match="a rank holds one device, not .*: a mesh of "
                                               "several devices is -Pdevice=<list> without "
                                               "torchrun"):
            resolve_devices(spec)
    for spec in ("cuda:1", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="this rank's card is cuda:2"):
            resolve_devices(spec)
    with pytest.raises(ValueError, match="a mesh mixes the CPU and cards"):
        resolve_devices("cpu,cuda:2")
    shards = Shards("cpu")
    assert (shards.count, shards.held, shards.devices) == (2, [0], (torch.device("cpu"),))
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    with pytest.raises(RuntimeError, match="on the CPU only under gloo"):
        resolve_devices("cpu")


@pytest.mark.parametrize("cards, local_rank, local_size, card", [
    (4, 1, 2, 1),  # two ranks on four cards: cards 2 and 3 stay idle
    (4, 0, 2, 0),
    (8, 1, 2, 1),
    (4, 3, 4, 3),  # phase 16's shape: a card each
    (1, 1, 2, 0),  # phase 15's: two ranks share the card (gloo)
    (2, 3, 4, 1),
    (3, 1, 2, 1),
], ids=["4-cards-r1-of-2", "4-cards-r0-of-2", "8-cards-r1-of-2", "4x1-r3", "2-ranks-1-card",
        "4-ranks-2-cards", "3-cards"])
def test_rank_block_of_cards(monkeypatch, capsys, cards, local_rank, local_size, card):
    """The one card a rank takes: initialize_distributed binds card
    LOCAL_RANK % device_count (set_device, and nccl's device_id where
    every local rank has a card of its own); in the group resolve_devices'
    "cuda" and None are that card, the card named is accepted, the CPU
    only under gloo, and another card or a list raises. The cards and
    the group are stand-ins."""
    import torch.distributed as dist

    from sfm_mvs_pipeline_tpu_torch import resolve_devices
    from sfm_mvs_pipeline_tpu_torch.parallel import distributed as D
    from sfm_mvs_pipeline_tpu_torch.utils import logger
    from tests.test_torch_distributed import stand_in_host

    calls = stand_in_host(monkeypatch, cards=cards, rank=local_rank, world=local_size)
    try:
        assert D.initialize_distributed()
    finally:
        logger.set_rank(0, 1)
    own = torch.device("cuda", card)
    backend = "nccl" if cards >= local_size else "gloo"
    assert calls["set"] == own and calls["backend"] == backend
    assert calls.get("device_id") == (own if backend == "nccl" else None)
    assert f"this rank's card: {card} GPU-uuid-of-{card}" in capsys.readouterr().out
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a: local_rank)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: local_size)
    monkeypatch.setattr(dist, "get_backend", lambda *a: backend)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: card)
    assert resolve_devices("cuda") == resolve_devices(None) == resolve_devices(str(own)) == (own,)
    if backend == "gloo":
        assert resolve_devices("cpu") == (torch.device("cpu"),)
    else:
        with pytest.raises(RuntimeError, match="on the CPU only under gloo"):
            resolve_devices("cpu")
    if cards > 1:
        with pytest.raises(RuntimeError, match=f"this rank's card is {own}"):
            resolve_devices(f"cuda:{(card + 1) % cards}")
    with pytest.raises(RuntimeError, match="a rank holds one device"):
        resolve_devices(f"{own},{own}")


# ------------------------------------------------------------ mesh helpers


def test_shard_leading_and_replicated():
    """Shards.leading: one contiguous block a shard of the leading axis
    padded with `fill`; Shards.replicated: x on each shard's device, one
    copy a distinct device."""
    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards

    shards = Shards("cpu,cpu,cpu,cpu")
    x = np.arange(10 * 3).reshape(10, 3)
    blocks = shards.leading(x, fill=-1)
    assert [b.shape[0] for b in blocks] == [3, 3, 3, 3]
    np.testing.assert_array_equal(torch.cat(blocks)[:10].numpy(), x)
    assert (torch.cat(blocks)[10:] == -1).all()
    assert [b.shape[0] for b in shards.leading(x[:8])] == [2, 2, 2, 2]  # no padding needed
    reps = shards.replicated(x)
    assert len(reps) == 4 and all(r is reps[0] for r in reps)  # one copy a distinct device
    np.testing.assert_array_equal(reps[0].numpy(), x)


def test_mesh_collectives_in_card_order():
    """Sums add in card order on the first device (bit for bit the left
    fold), gathers concatenate in card order, broadcast takes the source's
    tensor; every shard gets the sum."""
    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards

    shards = Shards("cpu,cpu,cpu,cpu")
    parts = [torch.as_tensor(np.random.default_rng(i).normal(size=1000) * 10 ** i)
             for i in range(4)]

    def one(sh):
        return (sh.all_reduce_sum(parts[sh.index]), sh.all_gather_cat(parts[sh.index][:3]),
                sh.broadcast(parts[sh.index], src=2), threading.current_thread().name)

    out = shards.run(one)
    fold = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    for total, cat, bc, _ in out:
        assert torch.equal(total, fold)
        assert torch.equal(cat, torch.cat([p[:3] for p in parts]))
        assert torch.equal(bc, parts[2])
    assert len({name for *_, name in out}) == 4  # a thread a shard


def test_a_failing_shard_raises_and_frees_the_others():
    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards

    def one(sh):
        if sh.index == 1:
            raise ValueError("shard 1 fails")
        return sh.all_reduce_sum(torch.ones(2))

    with pytest.raises(ValueError, match="shard 1 fails"):
        Shards("cpu,cpu,cpu").run(one)


def test_shard_threads_log_and_time(capsys):
    """A shard thread's log record is one line tagged with its shard and
    device; a stage's total is its longest shard's wall (shard i works
    0.05 (i + 1) s: 0.2 s, where the four added up would be 0.5 s), its
    calls every shard's."""
    import time

    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards
    from sfm_mvs_pipeline_tpu_torch.utils import logger as logging
    from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

    log = logging.AppLogger("Mesh")
    stage_timer.enable()
    try:
        def one(sh):
            with stage_timer.stage("shard work"):
                log.info(f"shard {sh.index} here")
                time.sleep(0.05 * (sh.index + 1))

        Shards("cpu,cpu,cpu,cpu").run(one)
        total, calls = stage_timer.report()["shard work"]
        assert calls == 4 and 0.2 <= total < 0.45, (total, calls)
    finally:
        stage_timer.enable(False)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "here" in ln]
    assert sorted(ln.split("Mesh ", 1)[1] for ln in lines) == [
        f"c{i}/4 cpu] shard {i} here" for i in range(4)]


def test_entry_points_take_device_or_devices(tmp_path):
    """device= and devices= of an entry point are one setting: at most one
    may be given."""
    from sfm_mvs_pipeline_tpu_torch.mvs.pipeline import run_mvs
    from sfm_mvs_pipeline_tpu_torch.sfm.incremental import reconstruct

    for call in (lambda: reconstruct(None, None, device="cpu", devices="cpu,cpu"),
                 lambda: run_mvs(None, str(tmp_path), device="cpu", devices="cpu")):
        with pytest.raises(ValueError, match="give device= or devices=, not both"):
            call()


# ---------------------------------------------------------------- matching


def _int_descriptors(seed=42, S=6, F=96, D=32):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 16, size=(F, D))
    desc = np.stack([base[rng.permutation(F)] + rng.integers(0, 2, size=(F, D))
                     for _ in range(S)]).astype(np.float32)
    for s in range(S):  # duplicated rows: tied distances, the lowest index wins
        desc[s, rng.integers(0, F, size=F // 8)] = desc[s, rng.integers(0, F, size=F // 8)]
    return desc, rng.random((S, F)) > 0.1


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_mesh_matching_bit_equal_to_jax_and_one_device(exact):
    from sfm_mvs_pipeline_tpu.ops.pairs import unordered_pairs
    from sfm_mvs_pipeline_tpu.parallel.matching import match_pairs_sharded as j_match
    from sfm_mvs_pipeline_tpu.parallel.mesh import make_mesh as j_mesh

    from sfm_mvs_pipeline_tpu_torch.ops.matching import match_pairs_batch
    from sfm_mvs_pipeline_tpu_torch.parallel.matching import match_pairs_sharded

    desc, valid = _int_descriptors()
    pairs = unordered_pairs(desc.shape[0]).astype(np.int32)  # 15 pairs: padded to 16
    got = [t.numpy() for t in match_pairs_sharded(desc, valid, pairs, with_distance=True,
                                                  exact=exact, device="cpu,cpu,cpu,cpu")]
    ref = [t.numpy() for t in match_pairs_batch(torch.as_tensor(desc), torch.as_tensor(valid),
                                                torch.as_tensor(pairs), with_distance=True,
                                                exact=exact)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    idx_j, mask_j, dist_j = (np.asarray(t) for t in j_match(
        j_mesh(4), desc, valid, pairs, backend="jnp", with_distance=True, exact=exact))
    vq = valid[pairs[:, 0]]
    np.testing.assert_array_equal(got[1], mask_j)
    np.testing.assert_array_equal(got[0][vq], idx_j[vq])
    np.testing.assert_array_equal(got[2][got[1]], dist_j[mask_j])
    assert got[1].mean() > 0.3


# ---------------------------------------------------------------------- BA


def _ba_args(layout):
    pts, poses, intr, op, osr, ouv = _ba_problem(np.random.default_rng(42))
    ow = np.ones(len(op))
    if layout == "track":  # a point observed twice in one shot
        op, osr = np.concatenate([op, op[:1]]), np.concatenate([osr, osr[:1]])
        ouv, ow = np.concatenate([ouv, ouv[:1] + 0.5]), np.ones(len(op))
    imask = np.zeros((1, 7))
    imask[0, 0] = 1.0
    return pts, poses, intr, np.zeros(len(poses), np.int32), op, osr, ouv, ow, imask


@pytest.mark.parametrize("layout", ["dense", "track"])
def test_mesh_ba_within_tolerance_and_repeatable(layout):
    from sfm_mvs_pipeline_tpu_torch.parallel.ba import run_bundle_adjustment_sharded
    from sfm_mvs_pipeline_tpu_torch.sfm.ba import BAConfig, run_bundle_adjustment

    args = _ba_args(layout)
    kw = dict(config=BAConfig(max_iterations=BA_ITERS), dtype=torch.float64)
    ref = run_bundle_adjustment(*args, device="cpu", **kw)
    runs = [run_bundle_adjustment_sharded(*args, device="cpu,cpu,cpu,cpu", **kw)
            for _ in range(2)]
    for k in ("points", "poses", "intrinsics"):
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)
    assert runs[0]["cost"] == runs[1]["cost"]
    got = runs[0]
    assert got["table_kind"] == ref["table_kind"] == layout
    assert got["cost"] == pytest.approx(ref["cost"], rel=1e-9)
    assert got["iterations"] == ref["iterations"]
    for k in ("points", "poses", "intrinsics"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-7, err_msg=k)
    one = run_bundle_adjustment_sharded(*args, device="cpu", **kw)  # a mesh of one device
    for k in ("points", "poses", "intrinsics", "cost"):
        np.testing.assert_array_equal(one[k], ref[k], err_msg=k)


def test_mesh_ba_vs_jax():
    from sfm_mvs_pipeline_tpu.parallel.ba import run_bundle_adjustment_sharded as j_ba
    from sfm_mvs_pipeline_tpu.parallel.mesh import make_mesh as j_mesh
    from sfm_mvs_pipeline_tpu.sfm.ba import BAConfig as JConfig

    from sfm_mvs_pipeline_tpu_torch.parallel.ba import run_bundle_adjustment_sharded
    from sfm_mvs_pipeline_tpu_torch.sfm.ba import BAConfig

    args = _ba_args("dense")
    got = run_bundle_adjustment_sharded(*args, config=BAConfig(max_iterations=BA_ITERS),
                                        dtype=torch.float64, device="cpu,cpu,cpu,cpu")
    oj = j_ba(j_mesh(4), *args, config=JConfig(max_iterations=BA_ITERS))
    assert got["cost"] == pytest.approx(oj["cost"], rel=1e-6)
    np.testing.assert_allclose(got["poses"], oj["poses"], atol=1e-6)
    np.testing.assert_allclose(got["points"], oj["points"], atol=1e-5)


# --------------------------------------------------------------------- CLI


def _cli(argv):
    from sfm_mvs_pipeline_tpu_torch.cli.app import main

    assert main(["-Prun=photogrammetrie", *argv]) == 0


def _same_dense(out_a, out_b, n_views):
    for i in range(n_views):
        np.testing.assert_array_equal(np.load(os.path.join(out_a, f"depth_{i:04d}.npy")),
                                      np.load(os.path.join(out_b, f"depth_{i:04d}.npy")),
                                      err_msg=f"depth map {i}")
    for name in ("pointcloud_dense.ply", "mesh_dense.ply"):
        assert filecmp.cmp(os.path.join(out_a, name), os.path.join(out_b, name), shallow=False), name


@pytest.fixture(scope="module")
def render_5(tmp_path_factory):
    from sfm_mvs_pipeline_tpu_torch.utils.synth import render_views

    out = tmp_path_factory.mktemp("render5")
    render_views(str(out), 5, 180, 240, 210.0)
    return str(out)


def test_cli_mesh_sfm_leaves_ba_unsharded(monkeypatch, tmp_path, capsys):
    """In a mesh BA runs on the first device whatever its size (the gate
    lowered to 1 observation a shard here): the mesh's sparse SfM on
    insel writes the same scene.npz as -Pdevice=cpu."""
    from sfm_mvs_pipeline_tpu_torch.sfm import incremental

    monkeypatch.setattr(incremental, "_SHARDED_BA_MIN_OBS", 1)
    mesh, one = str(tmp_path / "mesh"), str(tmp_path / "one")
    _cli([f"-Pimage={INSEL}", f"-Pout={mesh}", "-Pdevice=cpu,cpu"])
    log = capsys.readouterr().out
    assert "BA #1" in log and "point-sharded" not in log
    _cli([f"-Pimage={INSEL}", f"-Pout={one}", "-Pdevice=cpu"])
    a, b = (np.load(os.path.join(d, "scene.npz")) for d in (mesh, one))
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("data", ["insel", "render"])
def test_cli_mesh_dense_bit_equal_to_one_device(data, render_5, tmp_path, capsys):
    """-Pdevice=cpu,cpu,cpu,cpu --dense --sgm from the images, then
    PatchMatch resumed from its scene.npz, each against -Pdevice=cpu
    resumed from the same scene.npz. insel: 3 views for 4 shards (one
    shard computes none; 3 pairs: matching unsharded); the render: 5 views
    (2, 2, 1, 0 a shard), 10 pairs matched over the mesh."""
    images, n_views = (INSEL, 3) if data == "insel" else (render_5, 5)
    mesh, one = str(tmp_path / "mesh"), str(tmp_path / "one")
    flags = ["--dense", "--mesh", "--artifacts"]
    _cli([f"-Pimage={images}", f"-Pout={mesh}", "-Pdevice=cpu,cpu,cpu,cpu", "--sgm", *flags])
    log = capsys.readouterr().out
    assert "view-sharded depth maps over 4 devices" in log
    assert ("pair-sharded matching over 4 devices" in log) == (data == "render")
    assert sum(f"c{i}/4 cpu] view" in log for i in range(4)) == min(n_views, 3)
    scene = os.path.join(tmp_path, "scene.npz")
    for ext in ("", ".json"):
        os.replace(os.path.join(mesh, "scene.npz" + ext), scene + ext)
    _cli([f"-Presume={scene}", f"-Pout={one}", "-Pdevice=cpu", "--sgm", *flags])
    _same_dense(mesh, one, n_views)
    pm = ["-Pdense-method=patchmatch"]
    _cli([f"-Presume={scene}", f"-Pout={mesh}", "-Pdevice=cpu,cpu,cpu,cpu", *pm, *flags])
    _cli([f"-Presume={scene}", f"-Pout={one}", "-Pdevice=cpu", *pm, *flags])
    _same_dense(mesh, one, n_views)
