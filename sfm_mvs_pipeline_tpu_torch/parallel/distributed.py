"""Multi-process runtime: process-group bring-up, host-level work sharding
and the collectives the sharded paths use, over ranks or over the cards of
one process's mesh.

Port of sfm_mvs_pipeline_tpu/parallel/distributed.py. torchrun starts one
process per rank and exports RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT; initialize_distributed
reads them. In a single process everything degrades to no-ops, so the
pipeline code is the same either way.

The sharded functions are written once, over Shards, in one of two
shapes. A process's mesh (no process group of more than one rank): one
shard a device, each in a thread of its own under its card and a stream
of its own; their collectives (Shard.all_reduce_sum, all_gather_cat,
broadcast) meet at a rendezvous of the threads, which sums in card order
on the first device and concatenates there in card order, so repeated
runs give the same bits. torchrun's ranks, one device each: one shard a
rank, shard r on rank r (the process-major order of the JAX package's
jax.devices() after jax.distributed.initialize), and the collectives are
the process group's.

The backend follows a stated rule, never a caught failure: nccl when
every local rank has a card of its own, gloo when ranks share a card or run
on the CPU. gloo carries the collectives through the host, so the helpers
below hand it a CPU copy of a CUDA tensor and copy the result back (the
transport, not a fallback), and send bool tensors as uint8. Each
collective runs under a stage timer ("collective all_reduce", ...), so a
measurement with the timers on reads the time spent in them.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.parallel.mesh import (
    Mesh,
    block,
    make_mesh,
    pad_to_multiple,
    world,
)
from sfm_mvs_pipeline_tpu_torch.utils import logger as logging
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer
from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import stage

# ranks that diverge (one waits in a collective the others never enter)
# fail after this long instead of gloo's default 30 minutes
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

log = logging.AppLogger("Distributed")


def choose_backend(local_world_size: int) -> str:
    """nccl when every local rank has its own card; gloo when ranks share
    a card or there is none (a caller working on the CPU passes gloo to
    initialize_distributed)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def initialize_distributed(backend: str | None = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Bring up the default process group from torchrun's environment.

    Returns True when a group of more than one rank is live. A no-op
    returning False in a single process (no WORLD_SIZE in the environment),
    and safe to call more than once. `backend` None takes choose_backend's
    rule; each rank is bound to card LOCAL_RANK % device_count (one card a
    rank, or the card the ranks share under gloo where they outnumber the
    cards), and logs it."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    if "WORLD_SIZE" not in os.environ:
        return False
    size = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = choose_backend(local_size)
    card = None
    if n_cards:
        card = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(card)
    # under nccl the group is bound to the rank's card, so barrier and the
    # object collectives run there without torch guessing the device
    bound = {"device_id": card} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size,
                            timeout=timeout, **bound)
    logging.set_rank(rank, size)
    where = (f"{local_size} local rank(s) on {n_cards} card(s); this rank's card: "
             f"{card.index} {_card_id(card)}" if n_cards
             else f"{local_size} local rank(s), no card")
    log.info(f"process group: rank {rank} of {size}, backend {backend} ({where})")
    idle = n_cards - local_size
    if idle > 0 and local_rank == 0:
        log.warn(f"{idle} of {n_cards} cards stay idle: {local_size} local ranks take one "
                 f"card each; on one host, one process over every card (-Pdevice=cuda "
                 f"without torchrun) uses them all")
    return size > 1


def _card_id(card: torch.device) -> str:
    """The card's UUID as nvidia-smi prints it (GPU-...) and its PCI bus."""
    props = torch.cuda.get_device_properties(card)
    return f"GPU-{props.uuid}, PCI bus {props.pci_bus_id}"


def shutdown_distributed() -> None:
    """Leave the default process group, if this process joined one."""
    dist = _dist()
    if dist is not None:
        dist.destroy_process_group()
        logging.set_rank(0, 1)


def process_index() -> int:
    return world()[0]


def process_count() -> int:
    return world()[1]


def host_shard(items: list | np.ndarray, pad: bool = False):
    """The slice of a host-side work list this process owns (round-robin,
    deterministic across ranks). With pad=True every rank gets the same
    count (its last item repeated) so collectives stay shape-aligned."""
    p, n = world()
    if n == 1:
        return items
    own = list(items[p::n])
    if pad:
        per = -(-len(items) // n)
        while len(own) < per:
            own.append(own[-1] if own else items[0])
    return own


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _to_wire(t: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """The tensor a collective sends: on the backend's device (the rank's
    card under nccl, the CPU under gloo), bool as uint8; a fresh copy when
    `copy` (for the collectives that work in place)."""
    wire = (torch.device("cuda", torch.cuda.current_device())
            if _dist().get_backend() == "nccl" else torch.device("cpu"))
    dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
    return t.to(device=wire, dtype=dtype, copy=copy).contiguous()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks, on t's device (t itself in a single
    process)."""
    dist = _dist()
    if dist is None:
        return t
    with stage("collective all_reduce"):
        w = _to_wire(t, copy=True)
        dist.all_reduce(w)
        return w.to(device=t.device, dtype=t.dtype)


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every rank's t (equal shapes) concatenated along dim 0 in rank
    order, on t's device and in t's dtype."""
    dist = _dist()
    if dist is None:
        return t
    with stage("collective all_gather"):
        w = _to_wire(t)
        parts = [torch.empty_like(w) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, w)
        return torch.cat(parts).to(device=t.device, dtype=t.dtype)


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank src's t on every rank, on t's device."""
    dist = _dist()
    if dist is None:
        return t
    with stage("collective broadcast"):
        w = _to_wire(t, copy=True)
        dist.broadcast(w, src)
        return w.to(device=t.device, dtype=t.dtype)


def broadcast_object(obj, src: int = 0):
    """Rank src's picklable obj on every rank."""
    dist = _dist()
    if dist is None:
        return obj
    box = [obj]
    with stage("collective broadcast_object"):
        dist.broadcast_object_list(box, src)
    return box[0]


def barrier() -> None:
    dist = _dist()
    if dist is not None:
        with stage("collective barrier"):
            dist.barrier()


def assemble_global(local_arrays) -> torch.Tensor:
    """The global array from this rank's leading-axis block (images this
    rank decoded, descriptors it extracted, ...): an all_gather of every
    rank's block, concatenated in rank order. Single process: the block."""
    return all_gather_cat(torch.as_tensor(local_arrays))


def _gather_ints(value: int) -> list[int]:
    return all_gather_cat(torch.tensor([int(value)], dtype=torch.int64)).tolist()


def all_hosts_agree(value: int) -> bool:
    """Cheap cross-rank consistency check (e.g. the same number of images
    found): True when every rank passed the same value."""
    return len(set(_gather_ints(value))) == 1


# digest's fingerprint: rows of this many 32-bit words, summed this many
# words at a time (bounds its int64 temporaries to 128 MiB each)
_ROW = 4096
_CHUNK = 1 << 24


def _fingerprint(t: torch.Tensor) -> torch.Tensor:
    """(rows, 2) int64 on t's device: t's raw bits as 32-bit words (bytes
    when its size is no multiple of 4), in rows of _ROW words, each row's
    plain and position-weighted sums (exact in int64)."""
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if raw.numel() % 4:
        words = raw
    else:  # a 32-bit view needs an aligned start
        words = (raw if raw.storage_offset() % 4 == 0 else raw.clone()).view(torch.int32)
    weights = torch.arange(1, _ROW + 1, dtype=torch.int64, device=t.device)
    rows = [torch.zeros((0, 2), dtype=torch.int64, device=t.device)]
    for lo in range(0, words.numel(), _CHUNK):
        part = words[lo:lo + _CHUNK].to(torch.int64)
        part = torch.nn.functional.pad(part, (0, (-part.numel()) % _ROW)).view(-1, _ROW)
        rows.append(torch.stack([part.sum(1), (part * weights).sum(1)], 1))
    return torch.cat(rows)


def digest(*arrays) -> int:
    """A 63-bit digest of arrays or tensors (None allowed): shapes, dtypes
    and contents. A tensor is fingerprinted where it lies (_fingerprint);
    only the fingerprint, 1/256 of its bytes, goes to the host to be
    hashed."""
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        if a is None:
            h.update(b"None")
            continue
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.ascontiguousarray(a))
        h.update(f"{tuple(t.shape)} {t.dtype};".encode())
        h.update(_fingerprint(t).cpu().numpy().tobytes())
    return int.from_bytes(h.digest(), "little") >> 1


def check_agree(what: str, *arrays) -> None:
    """Raise when the ranks hold different `arrays` at the entry of a
    sharded function: ranks that repeat the replicated stages and diverge
    (another view registered, a restart on one rank only) would otherwise
    feed the collectives mismatched work. A tensor is fingerprinted where
    it lies (the rank's card)."""
    if _dist() is None:
        return
    seen = _gather_ints(digest(*arrays))
    if len(set(seen)) != 1:
        raise RuntimeError(f"{what}: the ranks' inputs differ (digests by rank {seen}); "
                           f"the replicated stages diverged")


# ---------------------------------------------------------------------------
# the shards this process holds: a rank, or the cards of a mesh


def _settled(t: torch.Tensor) -> torch.Tensor:
    """t, once the calling thread's stream on t's card has finished it: a
    tensor crosses between a mesh's threads (and so between streams) only
    settled."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


_LINALG_LOADED = threading.Event()


def _load_cuda_linalg(dev: torch.device) -> None:
    """torch loads its CUDA linear-algebra library at the first linalg call
    on a card, and two threads making that first call at once fail ("lazy
    wrapper should be called at most once"): make it once on the calling
    thread before a mesh's threads start."""
    if not _LINALG_LOADED.is_set():
        torch.linalg.cholesky_ex(torch.ones((1, 1), device=dev))
        _LINALG_LOADED.set()


class _Rendezvous:
    """Where the shard threads of a mesh meet for a collective: each puts
    its tensor in its slot, the first shard's thread combines them, each
    takes the result."""

    def __init__(self, n: int):
        self.slots = [None] * n
        self.result = None
        self.barrier = threading.Barrier(n, timeout=DEFAULT_TIMEOUT.total_seconds())

    def exchange(self, local: int, t: torch.Tensor, combine) -> torch.Tensor:
        self.slots[local] = _settled(t)
        self.barrier.wait()  # every slot filled
        if local == 0:
            self.result = _settled(combine(self.slots))
        # the result made; the first shard replaces it only after the next
        # exchange's first wait, which every shard reaches after taking it
        self.barrier.wait()
        return self.result


class Shard:
    """One shard of a sharded function: its index among `count` shards,
    its device, and the collectives over every shard: the threads' of a
    mesh where the shards meet at a rendezvous `rv`, else the process
    group's (a rank, or a mesh of one device, where they return t).
    `local` is its place among the shards of its process."""

    def __init__(self, shards: Shards, local: int, rv=None):
        self.shards, self.local, self._rv = shards, local, rv
        self.index, self.device = shards.held[local], shards.devices[local]
        self.count = shards.count

    def _meet(self, what: str, t: torch.Tensor, combine) -> torch.Tensor:
        with stage(f"collective {what}"):
            return self._rv.exchange(self.local, t, combine)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the shards, on this shard's device; a mesh's
        in card order on its first device."""
        if self._rv is None:
            return all_reduce_sum(t)
        first = self.shards.first

        def total(parts):
            acc = parts[0].to(first, copy=True)
            for p in parts[1:]:
                acc += p.to(first)
            return acc

        return _settled(self._meet("all_reduce", t, total).to(self.device, copy=True))

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        """Every shard's t (equal shapes) concatenated along dim 0 in shard
        order; a mesh's on its first device (the same tensor for every
        shard)."""
        if self._rv is None:
            return all_gather_cat(t)
        first = self.shards.first
        return self._meet("all_gather", t, lambda parts: torch.cat([p.to(first) for p in parts]))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Shard src's t, on this shard's device."""
        if self._rv is None:
            return broadcast(t, src)
        return _settled(self._meet("broadcast", t, lambda parts: parts[src])
                        .to(self.device, copy=True))


class Shards:
    """The shards this process holds of a sharded function's `count`, one
    a device it holds: in one process every device of the mesh (count =
    its size); under torchrun the rank's one device (resolve_devices: its
    card, or the CPU under gloo), shard `rank` of count = world. `devices`
    is a Mesh or a resolve_devices spec. `kind` names the shape in the
    logs."""

    def __init__(self, devices=None):
        rank, size = world()
        self.ranks = size > 1
        self.mesh = make_mesh(devices.devices if isinstance(devices, Mesh) else devices)
        if self.ranks:
            self.held, self.count, self.kind = [rank], size, "ranks"
        else:
            self.held, self.count = list(range(len(self.mesh))), len(self.mesh)
            self.kind = "devices"
        self.devices = self.mesh.devices
        self.first = self.mesh.first

    @classmethod
    def of_entry(cls, device, devices) -> Shards:
        """An entry point's shards (reconstruct, run_mvs): its `devices`, or
        its `device`, the same setting under two names, so at most one may
        be given."""
        if device is not None and devices is not None:
            raise ValueError("give device= or devices=, not both")
        return cls(devices if devices is not None else device)

    def replicated(self, x) -> list[torch.Tensor]:
        """x on the device of each shard this process holds, in shard order;
        one copy a distinct device (shards on one card share it)."""
        t = torch.as_tensor(x)
        copies = {dev: t.to(dev) for dev in dict.fromkeys(self.devices)}
        return [copies[dev] for dev in self.devices]

    def leading(self, x, fill=0) -> list[torch.Tensor]:
        """The contiguous blocks of x's leading axis (padded with `fill` to
        a multiple of the shard count) of the shards this process holds,
        each on its shard's device, in shard order: in a mesh every block,
        under torchrun the rank's."""
        t = torch.as_tensor(x)
        n = t.shape[0]
        if n % self.count:
            t = torch.as_tensor(pad_to_multiple(t.cpu().numpy(), self.count, fill))
        return [t[slice(*block(n, i, self.count))].to(dev)
                for i, dev in zip(self.held, self.devices)]

    def run(self, fn, *per_shard) -> list:
        """[fn(shard, *its items of per_shard) for each shard this process
        holds], in shard order; each of `per_shard` is a list with one item
        a held shard (Shards.replicated, Shards.leading). One shard (a rank,
        or a mesh of one device) runs in the calling thread. A mesh of
        several runs each in a thread of its own under its card: the first
        shard of a card on the caller's current stream there, any other on
        a stream of its own, each tagged in the log and its spans with its
        shard (stage_timer.merge keeps each stage's longest shard). A
        failing shard breaks the others' collectives, and the first failure
        is raised. Under torchrun a failing rank fails the collectives of
        the other ranks."""
        if len(self.held) == 1:
            return [fn(Shard(self, 0), *(p[0] for p in per_shard))]
        streams, seen = [], set()
        for dev in self.devices:
            if dev.type != "cuda":
                streams.append(None)
                continue
            _load_cuda_linalg(dev)
            cur = torch.cuda.current_stream(dev)
            cur.synchronize()  # the caller's inputs are ready for every thread
            streams.append(torch.cuda.Stream(dev) if dev in seen else cur)
            seen.add(dev)
        rv = _Rendezvous(len(self.held))
        timed = []  # each shard thread's stages

        def work(i: int):
            dev = self.devices[i]
            with contextlib.ExitStack() as ctx:
                if streams[i] is not None:
                    ctx.enter_context(torch.cuda.device(dev))
                    ctx.enter_context(torch.cuda.stream(streams[i]))
                ctx.enter_context(logging.shard_tag(self.held[i], self.count, dev))
                ctx.enter_context(stage_timer.shard_thread(timed, self.held[i]))
                try:
                    out = fn(Shard(self, i, rv), *(p[i] for p in per_shard))
                except BaseException:
                    rv.barrier.abort()  # the other shards leave their collectives
                    raise
                if streams[i] is not None:
                    streams[i].synchronize()
                return out

        try:
            with ThreadPoolExecutor(len(self.held), thread_name_prefix="shard") as pool:
                futures = [pool.submit(work, i) for i in range(len(self.held))]
        finally:
            stage_timer.merge(timed)
        errors = [f.exception() for f in futures if f.exception() is not None]
        if errors:
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return [f.result() for f in futures]
