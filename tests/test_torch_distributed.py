"""The port's multi-process runtime (parallel/distributed.py), its dryrun
and its CLI under torchrun, with real gloo process groups on the CPU.

The twin of tests/test_distributed.py: worker processes are started with
`python -c` / `-m` and torchrun's environment (RANK, WORLD_SIZE, ...) on a
free localhost port, each with one torch thread; they import only the
port. Every launch has a timeout.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSEL = os.path.join(REPO, "sample_data", "insel")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(argv: list[str], world: int, env: dict | None = None,
              timeout: float = 120) -> list[tuple[int, str]]:
    """Run `python <argv>` once per rank of a `world`-rank group on a free
    port; returns each rank's (exit code, output), failing the test on the
    timeout (every process is killed then)."""
    port = str(free_port())
    procs = []
    for rank in range(world):
        penv = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                    LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                    OMP_NUM_THREADS="1", PYTHONPATH=REPO, **(env or {}))
        procs.append(subprocess.Popen([sys.executable, *argv], env=penv, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate()[0].decode()[-2000:] for p in procs]
        pytest.fail(f"{world} ranks of {argv[:2]} timed out after {timeout} s; their output:\n"
                    + "\n".join(f"--- rank {r}:\n{t}" for r, t in enumerate(tails)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def launch_ranks(argv: list[str], world: int, env: dict | None = None,
                 timeout: float = 120) -> list[str]:
    """run_ranks, failing the test on a non-zero exit; returns each rank's
    output."""
    res = run_ranks(argv, world, env, timeout)
    for rank, (rc, out) in enumerate(res):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-4000:]}"
    return [out for _, out in res]


_HELPERS = r"""
import os
import numpy as np
import torch
torch.set_num_threads(1)
from sfm_mvs_pipeline_tpu_torch.parallel import distributed as D

rank = int(os.environ["RANK"])
assert D.initialize_distributed() is True
assert D.initialize_distributed() is True  # safe to call twice
import torch.distributed as dist
assert dist.get_backend() == "gloo"  # no card here
assert D.process_count() == 2 and D.process_index() == rank

# host-level work sharding: disjoint, covering; padded to equal counts
assert D.host_shard(list(range(10))) == list(range(10))[rank::2]
assert len(D.host_shard(list(range(5)), pad=True)) == 3

# the global array from each rank's leading-axis block, in rank order
arr = D.assemble_global(np.full((2, 3), rank, np.float32))
assert arr.shape == (4, 3) and float(arr.sum()) == 6.0, arr
mask = D.all_gather_cat(torch.tensor([rank == 0, True]))  # bool over gloo
assert mask.dtype == torch.bool and mask.tolist() == [True, True, False, True]
assert float(D.all_reduce_sum(torch.tensor([rank + 1.0], dtype=torch.float64))) == 3.0
assert float(D.broadcast(torch.tensor([rank + 5]))) == 5
assert D.broadcast_object({"r": rank}) == {"r": 0}

assert D.all_hosts_agree(42)
assert not D.all_hosts_agree(rank)
D.check_agree("same", np.arange(6), None)
try:
    D.check_agree("diverged", np.arange(6) + rank)
except RuntimeError as e:
    assert "diverged" in str(e)
else:
    raise AssertionError("check_agree passed different inputs")
D.barrier()
D.shutdown_distributed()
print(f"rank {rank} OK", flush=True)
"""


def test_two_process_group():
    outs = launch_ranks(["-c", _HELPERS], 2)
    for rank, out in enumerate(outs):
        assert f"rank {rank} OK" in out
        assert f"Distributed r{rank}/2] process group: rank {rank} of 2, backend gloo" in out


def test_single_process_degenerates(monkeypatch):
    """Single process: bring-up is a no-op, host_shard returns everything,
    the collectives return their input, the ranks trivially agree."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.parallel import distributed as D
    from sfm_mvs_pipeline_tpu_torch.parallel.mesh import block, pad_to_multiple, world

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert D.initialize_distributed() is False
    assert D.process_count() == 1 and D.process_index() == 0 and world() == (0, 1)
    items = list(range(10))
    assert D.host_shard(items) == items
    assert D.all_hosts_agree(10)
    D.check_agree("one", np.arange(3))
    t = torch.arange(6.0).reshape(3, 2)
    assert D.assemble_global(t) is t and D.all_reduce_sum(t) is t and D.broadcast(t) is t
    assert D.choose_backend(2) == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    assert pad_to_multiple(np.arange(15), 4).tolist() == list(range(15)) + [0]
    assert block(15, 3, 4) == (12, 16)


@pytest.mark.parametrize("cards,local,backend", [(4, 4, "nccl"), (1, 1, "nccl"),
                                                   (1, 4, "gloo"), (2, 4, "gloo"),
                                                   (0, 1, "gloo")])
def test_choose_backend(monkeypatch, cards, local, backend):
    """nccl only when every local rank has a card of its own."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.parallel import distributed as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert D.choose_backend(local) == backend


@pytest.mark.parametrize("local_rank,backend", [(2, "nccl"), (2, "gloo")])
def test_initialize_binds_the_rank_card_under_nccl(monkeypatch, capsys, local_rank, backend):
    """Rank 2 of 4 on a host of four cards takes cuda:2, binds it to the
    group under nccl (device_id) and logs the card's index, UUID and PCI bus; a
    gloo group gets no device_id. The card and the group are stand-ins."""
    import types

    import torch
    import torch.distributed as dist

    from sfm_mvs_pipeline_tpu_torch.parallel import distributed as D
    from sfm_mvs_pipeline_tpu_torch.utils import logger

    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.setdefault("set", d))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid=f"uuid-of-{d.index}",
                                                        pci_bus_id=24 + d.index))
    monkeypatch.setattr(logger, "_global_level", logger.INFO)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda b, **kw: calls.update(backend=b, **kw))
    for k, v in dict(RANK=str(local_rank), WORLD_SIZE="4", LOCAL_RANK=str(local_rank),
                     LOCAL_WORLD_SIZE="4").items():
        monkeypatch.setenv(k, v)
    try:
        assert D.initialize_distributed(backend=None if backend == "nccl" else backend)
    finally:
        logger.set_rank(0, 1)
    card = torch.device("cuda", local_rank)
    assert calls["set"] == card and calls["backend"] == backend
    assert calls.get("device_id") == (card if backend == "nccl" else None)
    out = capsys.readouterr().out
    assert f"backend {backend} (4 local rank(s) on 4 card(s); this rank's card: 2 " \
           f"GPU-uuid-of-2, PCI bus 26)" in out, out


def stand_in_host(monkeypatch, cards: int, rank: int, world: int) -> dict:
    """A host of `cards` stand-in cards and torchrun's environment for rank
    `rank` of `world` on it; the group is a stand-in too. Returns the dict
    that set_device and init_process_group record their arguments in."""
    import types

    import torch
    import torch.distributed as dist

    from sfm_mvs_pipeline_tpu_torch.utils import logger

    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.setdefault("set", d))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid=f"uuid-of-{d.index}",
                                                        pci_bus_id=24 + d.index))
    monkeypatch.setattr(logger, "_global_level", logger.INFO)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda b, **kw: calls.update(backend=b, **kw))
    for k, v in dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                     LOCAL_WORLD_SIZE=str(world)).items():
        monkeypatch.setenv(k, v)
    return calls


@pytest.mark.parametrize("cards, idle", [(3, 1), (4, 2), (1, 0), (5, 3), (2, 0)])
def test_initialize_warns_of_idle_cards(monkeypatch, capsys, cards, idle):
    """Two local ranks take one card each: on a host of more cards the
    rest stay idle, and local rank 0 says so once; on two cards, or one
    card the ranks share, every card is used and nothing is said."""
    from sfm_mvs_pipeline_tpu_torch.parallel import distributed as D
    from sfm_mvs_pipeline_tpu_torch.utils import logger

    stand_in_host(monkeypatch, cards=cards, rank=0, world=2)
    try:
        D.initialize_distributed(backend="gloo")
    finally:
        logger.set_rank(0, 1)
    out = capsys.readouterr().out
    said = f"{idle} of {cards} cards stay idle: 2 local ranks take one card each"
    assert (said in out) == bool(idle) and ("stay idle" in out) == bool(idle), out


def test_log_record_is_one_write(monkeypatch):
    """Each log record, newline included, reaches stdout in one write:
    torchrun's ranks share an unbuffered stdout, where a separate newline
    write lets another rank's record into the middle of the line."""
    import io

    from sfm_mvs_pipeline_tpu_torch.utils import logger

    class Writes(io.StringIO):
        def __init__(self):
            super().__init__()
            self.calls = []

        def write(self, text):
            self.calls.append(text)
            return super().write(text)

    out = Writes()
    monkeypatch.setattr(logger, "_global_level", logger.INFO)
    monkeypatch.setattr(sys, "stdout", out)
    logger.AppLogger("Test").info("one record")
    assert len(out.calls) == 1 and out.calls[0].endswith("Test] one record\n"), out.calls


def test_digest_tells_arrays_apart():
    import torch

    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import digest

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert digest(a) == digest(torch.from_numpy(a.copy())) == digest(a.copy())
    b = a.copy()
    b[2, 3] = np.nextafter(b[2, 3], np.float32(100))
    assert digest(b) != digest(a)  # one ulp
    assert digest(a.reshape(4, 3)) != digest(a)  # shape
    assert digest(a.astype(np.float64)) != digest(a)  # dtype
    assert digest(a, None) != digest(a)
    # the fingerprint is taken on the tensor's device and does not depend
    # on where the tensor starts in its storage (here 6 bytes in)
    t = torch.arange(21, dtype=torch.float32).reshape(7, 3).to(torch.bfloat16)
    assert t[1:].storage_offset() * 2 % 4 and digest(t[1:]) == digest(t[1:].clone())
    assert digest(t[1:]) != digest(t[:-1])


def test_dryrun_multichip_world_2():
    outs = launch_ranks(["-m", "sfm_mvs_pipeline_tpu_torch.parallel.dryrun", "--device", "cpu"],
                        2)
    for rank, out in enumerate(outs):
        assert f"dryrun rank {rank} of 2: OK" in out


def stage_names(log: str, world: int) -> list[set[str]]:
    """Each rank's stage names from its --stage-times line."""
    names = []
    for r in range(world):
        line = next(ln for ln in log.splitlines()
                    if f"PhotogrammetrieCli r{r}/{world}] stage times: " in ln)
        names.append({part.rsplit(" ", 3)[0]
                      for part in line.split("stage times: ", 1)[1].split("; ")})
    return names


@pytest.fixture(scope="module")
def insel_world2(tmp_path_factory):
    """The CLI on insel at world 2 under torchrun (gloo, CPU), with
    --dense --sgm --artifacts."""
    out = tmp_path_factory.mktemp("cli_w2") / "out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
           "-m", "sfm_mvs_pipeline_tpu_torch", "-Prun=photogrammetrie", "-Pdevice=cpu",
           f"-Pimage={INSEL}", f"-Pout={out}", "--dense", "--sgm", "--artifacts", "--stats",
           "--stage-times"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    res = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    return out, res.stdout


def test_cli_world2_rank0_writes(insel_world2):
    """3/3 views, the sharded matching and depth-map branches taken on both
    ranks, and only rank 0 wrote: every output exists, and only rank 0
    logged the reprojection statistics it writes with the stats CSVs."""
    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene

    out, log = insel_world2
    scene = load_scene(str(out / "scene.npz"))
    assert int(scene.recovered.sum()) == 3
    for r in (0, 1):
        assert f"SfM r{r}/2] pair-sharded matching over 2 ranks" in log
        assert f"MVS r{r}/2] view-sharded depth maps over 2 ranks" in log
        assert f"PhotogrammetrieCli r{r}/2] stage times: " in log
    assert "collective all_gather" in log
    assert "PhotogrammetrieCli r0/2] reprojection error" in log
    assert "PhotogrammetrieCli r1/2] reprojection error" not in log
    # rank 1 stops after the depth-map gather: no fusion of its own
    stages = stage_names(log, 2)
    assert "depth-map gather" in stages[1] and "fusion" in stages[0]
    assert not {"fusion", "mesh", "texture"} & stages[1], stages[1]
    names = sorted(os.listdir(out))
    for name in ("pointcloud_sparse.ply", "cameras_recovered.ply", "scene.npz", "app.stat.csv",
                 "reprojectionerror.stat.csv", "pointcloud_dense.ply", "depth_0000.npy",
                 "depth_0002.npy", "scene.txt"):
        assert name in names, names
    assert not [n for n in names if n.startswith(".") or "tmp" in n], names


def test_cli_world2_depth_maps_equal_world1(insel_world2, tmp_path):
    """The depth maps of the world-2 run are bit-equal to a world-1 run
    resumed from its scene.npz (one scene, so no RANSAC draw differs)."""
    from sfm_mvs_pipeline_tpu_torch.cli.app import main

    out2, _ = insel_world2
    out1 = tmp_path / "w1"
    rc = main(["-Prun=photogrammetrie", "-Pdevice=cpu", f"-Presume={out2 / 'scene.npz'}",
               f"-Pout={out1}", "--dense", "--sgm", "--artifacts", "-Ploglevel=4"])
    assert rc == 0
    for i in range(3):
        d1 = np.load(out1 / f"depth_{i:04d}.npy")
        d2 = np.load(out2 / f"depth_{i:04d}.npy")
        assert (d1 > 0).mean() > 0.5
        np.testing.assert_array_equal(d2, d1)


def test_cli_world2_resumes_inside_its_own_out(insel_world2, tmp_path):
    """World 2 resumed from <out>/scene.npz with the same -Pout=: rank 0
    stashes the checkpoint before it wipes -Pout=, every rank reads the
    stash and waits at the barrier before rank 0 removes it, and the
    re-saved scene.npz holds the same scene."""
    import shutil

    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene

    out2, _ = insel_world2
    out = tmp_path / "out"
    out.mkdir()
    for name in ("scene.npz", "scene.npz.json"):
        shutil.copy2(out2 / name, out / name)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    outs = launch_ranks(["-m", "sfm_mvs_pipeline_tpu_torch", "-Prun=photogrammetrie",
                         "-Pdevice=cpu", f"-Presume={out / 'scene.npz'}", f"-Pout={out}"], 2,
                        env={"TMPDIR": str(tmp)})
    for rank, o in enumerate(outs):
        assert f"PhotogrammetrieCli r{rank}/2] resumed scene: " in o, o[-2000:]
    assert not os.listdir(tmp)  # the stash is gone
    a, b = load_scene(str(out2 / "scene.npz")), load_scene(str(out / "scene.npz"))
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.poses, b.poses)
    assert sorted(os.listdir(out)) == ["cameras_recovered.ply", "pointcloud_sparse.ply",
                                       "scene.npz", "scene.npz.json"]


def test_cli_world4_insel(tmp_path):
    """The CLI on insel at world 4 (gloo, one thread a rank): 3 pairs and 3
    views for 4 ranks, so matching runs unsharded (fewer pairs than ranks)
    and rank 3 computes no view. 3/3 views; rank 0 alone wrote and alone
    fused and meshed (ranks
    1-3 stop after the depth-map gather); the depth maps are bit-equal to a
    world-1 run resumed from the run's scene.npz, and so are the dense
    cloud and the mesh."""
    from sfm_mvs_pipeline_tpu_torch.cli.app import main
    from sfm_mvs_pipeline_tpu_torch.utils.checkpoint import load_scene

    out4 = tmp_path / "w4"
    flags = ["-Prun=photogrammetrie", "-Pdevice=cpu", "--dense", "--sgm", "--mesh",
             "--artifacts"]
    outs = launch_ranks(["-m", "sfm_mvs_pipeline_tpu_torch", *flags, f"-Pimage={INSEL}",
                         f"-Pout={out4}", "--stats", "--stage-times"], 4, timeout=300)
    log = "".join(outs)
    assert int(load_scene(str(out4 / "scene.npz")).recovered.sum()) == 3
    stages = stage_names(log, 4)
    for r in range(4):
        assert f"SfM r{r}/4] pair-sharded matching" not in log
        assert f"MVS r{r}/4] view-sharded depth maps over 4 ranks" in log
        assert "depth-map gather" in stages[r]
        assert (f"PhotogrammetrieCli r{r}/4] reprojection error" in log) == (r == 0)
        assert (f"MVS r{r}/4] fused dense cloud" in log) == (r == 0)
        if r:
            assert not {"fusion", "mesh", "texture"} & stages[r], stages[r]
    assert {"fusion", "mesh"} <= stages[0]

    out1 = tmp_path / "w1"
    assert main([*flags, f"-Presume={out4 / 'scene.npz'}", f"-Pout={out1}",
                 "-Ploglevel=4"]) == 0
    for i in range(3):
        d1 = np.load(out1 / f"depth_{i:04d}.npy")
        assert (d1 > 0).mean() > 0.5
        np.testing.assert_array_equal(np.load(out4 / f"depth_{i:04d}.npy"), d1)
    for name in ("pointcloud_dense.ply", "mesh_dense.ply"):
        assert (out4 / name).read_bytes() == (out1 / name).read_bytes(), name


# ------------------------------------- Shards and Shard at one device a rank

_TWO_RANKS = r"""
import contextlib, io, json, os
import numpy as np
import torch
torch.set_num_threads(1)
from sfm_mvs_pipeline_tpu_torch import resolve_devices
from sfm_mvs_pipeline_tpu_torch.cli.app import main
from sfm_mvs_pipeline_tpu_torch.parallel import distributed as D

rank = int(os.environ["RANK"])
D.initialize_distributed(backend="gloo")
out = {}
shards = D.Shards("cpu")
out["shape"] = [shards.count, shards.held, shards.kind]
parts = [torch.as_tensor(np.random.default_rng(i).normal(size=1000) * 10 ** i)
         for i in range(2)]


def one(sh):
    return {"index": sh.index, "sum": sh.all_reduce_sum(parts[sh.index]).tolist(),
            "cat": sh.all_gather_cat(parts[sh.index][:3] + 0).tolist(),
            "cat_bool": sh.all_gather_cat(torch.tensor([sh.index % 2 == 0])).tolist(),
            "bc0": sh.broadcast(parts[sh.index], src=0).tolist(),
            "bc1": sh.broadcast(parts[sh.index], src=1).tolist()}


out["shards"] = shards.run(one)
out["fold"] = (parts[0] + parts[1]).tolist()
out["parts"] = [p.tolist() for p in parts]
out["leading"] = [b.tolist() for b in shards.leading(np.arange(9), fill=-1)]
# a rank holds one device: a list of several raises, before the CLI wipes -Pout=
out["several"] = {}
for what, call in (("resolve_devices", lambda: resolve_devices("cpu,cpu")),
                   ("Shards", lambda: D.Shards("cpu,cpu"))):
    try:
        call()
        out["several"][what] = "no error"
    except RuntimeError as e:
        out["several"][what] = str(e)
log = io.StringIO()
with contextlib.redirect_stdout(log):
    rc = main(["-Prun=photogrammetrie", "-Pdevice=cpu,cpu", "-Pimage=" + os.environ["IMAGES"],
               "-Pout=" + os.environ["CLI_OUT"] % rank])
out["several"]["cli"] = f"rc {rc}: {log.getvalue()}"
out["cli_out_left"] = os.listdir(os.path.dirname(os.environ["CLI_OUT"]))
D.shutdown_distributed()
with open(os.environ["OUT"] % rank, "w") as f:
    json.dump(out, f)
print(f"rank {rank} OK", flush=True)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each rank's results of _TWO_RANKS at 2 gloo ranks of one CPU
    shard each."""
    import json

    tmp = tmp_path_factory.mktemp("two_ranks")
    (tmp / "cli").mkdir()
    pattern = str(tmp / "r%d.json")
    launch_ranks(["-c", _TWO_RANKS], 2, timeout=120,
                 env={"OUT": pattern, "IMAGES": INSEL, "CLI_OUT": str(tmp / "cli" / "out%d")})
    return [json.load(open(pattern % r)) for r in range(2)]


def test_ranks_by_cards_shards(two_ranks):
    """Rank r holds shard r of 2, and its block of the leading axis."""
    padded = list(range(9)) + [-1]
    for r, out in enumerate(two_ranks):
        assert out["shape"] == [2, [r], "ranks"]
        assert [sh["index"] for sh in out["shards"]] == [r]
        assert out["leading"] == [padded[5 * r:5 * (r + 1)]]


@pytest.mark.parametrize("what", ["all_reduce_sum", "all_gather_cat", "broadcast"])
def test_ranks_by_cards_collectives_in_global_order(two_ranks, what):
    """A rank's shard meets the others in the process group: the sum (bit
    for bit p0 + p1), gathers in rank order (bool too), broadcast from
    either rank, on every rank."""
    parts = two_ranks[0]["parts"]
    for out in two_ranks:
        for sh in out["shards"]:
            if what == "all_reduce_sum":
                assert sh["sum"] == out["fold"]
            elif what == "all_gather_cat":
                assert sh["cat"] == [x for p in parts for x in p[:3]]
                assert sh["cat_bool"] == [True, False]
            else:
                assert sh["bc0"] == parts[0] and sh["bc1"] == parts[1]


def test_ranks_by_cards_unequal_shard_counts_raise(two_ranks):
    """A rank given cpu,cpu raises: resolve_devices, Shards and the CLI
    (exit 1, before it wipes -Pout=), each naming the mesh instead."""
    for out in two_ranks:
        for what, said in out["several"].items():
            assert "a rank holds one device, not cpu,cpu: a mesh of several devices is " \
                   "-Pdevice=<list> without torchrun" in said, (what, said)
        assert out["several"]["cli"].startswith("rc 1: ")
        assert out["cli_out_left"] == []


_FAILING_SHARD = r"""
import os
import torch
torch.set_num_threads(1)
from sfm_mvs_pipeline_tpu_torch.parallel import distributed as D

D.initialize_distributed(backend="gloo")


def one(sh):
    sh.all_reduce_sum(torch.ones(2))
    if sh.index == 1:
        raise ValueError("shard 1 fails")
    return sh.all_reduce_sum(torch.ones(2))


D.Shards("cpu").run(one)
print("finished", flush=True)
"""


def test_ranks_by_cards_a_failing_shard_fails_every_rank():
    """Shard 1 (rank 1's) fails after one collective: rank 1 raises it,
    and rank 0, waiting in the next sum, fails too, well within the test's
    timeout (the group's own timeout is 10 minutes)."""
    import time

    t0 = time.perf_counter()
    res = run_ranks(["-c", _FAILING_SHARD], 2, timeout=60)
    assert time.perf_counter() - t0 < 60
    assert all(rc != 0 for rc, _ in res), res
    assert "ValueError: shard 1 fails" in res[1][1]
    assert not any("finished" in out for _, out in res)
