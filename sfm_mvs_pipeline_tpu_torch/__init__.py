"""sfm_mvs_pipeline_tpu_torch — the PyTorch + CUDA port of sfm_mvs_pipeline_tpu.

The same photogrammetry pipeline (SIFT -> brute-force 2-NN matching ->
incremental pose recovery -> triangulation -> bundle adjustment, then dense
MVS with the rect, sweep or PatchMatch engine and optional SGM -> fusion ->
meshing -> texturing) with the same module layout, flags and artifacts as
the JAX package beside it. Plain tensor code is PyTorch; every kernel the
JAX package wrote in Pallas for its main paths is a CUDA C++ kernel for
Hopper under csrc/, built at first use: K1 the batched 2-NN matcher
(match_kernel.cu), K2a/K2b SGM aggregation (sgm_kernel.cu) and K3 the
rectified PatchMatch scorer (pm_kernel.cu).

This package imports neither jax nor sfm_mvs_pipeline_tpu.
"""

import torch as _torch

# Geometry code (DLT systems, normal equations, the BA camera solve) needs
# full fp32 products: reduced-precision inputs destroyed the RANSAC/DLT
# conditioning on the TPU (essential/PnP inlier ratios collapsed from ~0.6
# to ~0.01), and TF32 keeps only ~3 decimal digits. Matmuls and convolutions
# therefore run in full fp32 on the card.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

APP_NAME = "sfm-mvs-pipeline-tpu-torch"
APP_VERSION = __version__


def default_device() -> _torch.device:
    """The card. Raises when there is none: the port never falls back to the
    CPU on its own. A caller that wants the CPU (where every kernel wrapper
    takes its plain PyTorch version) passes device="cpu" to the entry point,
    or -Pdevice=cpu to the CLI."""
    if not _torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "(CLI: -Pdevice=cpu) to run on the CPU"
        )
    return _torch.device("cuda")


def _checked(device: _torch.device | str) -> _torch.device:
    """`device` as a torch.device; raises for a card that does not exist."""
    dev = _torch.device(device)
    if dev.type == "cuda":
        default_device()
        if dev.index is not None and dev.index >= _torch.cuda.device_count():
            raise RuntimeError(f"no card {dev}: this machine has "
                               f"{_torch.cuda.device_count()}")
    elif dev.type != "cpu":
        raise ValueError(f"unknown device {device!r} (expected cuda, cuda:<n> or cpu)")
    return dev


def resolve_device(device: _torch.device | str | None) -> _torch.device:
    """The device an entry point runs on: `device` when given, else the
    card (default_device)."""
    return _checked(device) if device is not None else default_device()


def resolve_devices(spec=None) -> tuple[_torch.device, ...]:
    """The devices of the mesh an entry point shards over, the counterpart
    of the JAX package's jax.devices().

    `spec` is None, "cuda" or torch.device("cuda") (every visible card),
    "cpu", one named device, or several as a comma-separated string or a
    sequence: "cuda:0,cuda:1,cuda:2,cuda:3", "cuda:0,cuda:0" (two shards
    on one card), "cpu,cpu,cpu,cpu". Raises without a card where one is
    asked for, for a card that does not exist and for a mesh that mixes
    the CPU and cards.

    Inside a process group of more than one rank (torchrun) a rank holds
    one device: None, "cuda" and torch.device("cuda") are its card, the
    one initialize_distributed bound (LOCAL_RANK % device_count); a device
    named must be that card, or the CPU under gloo; a list of several
    raises. Nothing falls back to the CPU or to fewer cards."""
    from sfm_mvs_pipeline_tpu_torch.parallel.mesh import world

    ranks = world()[1] > 1
    if isinstance(spec, _torch.device) and spec.type == "cuda" and spec.index is None:
        spec = "cuda"
    if spec is None or (isinstance(spec, str) and spec.strip().lower() == "cuda"):
        default_device()
        if ranks:
            return (_torch.device("cuda", _torch.cuda.current_device()),)
        return tuple(_torch.device("cuda", i) for i in range(_torch.cuda.device_count()))
    if isinstance(spec, str):
        spec = [p.strip() for p in spec.lower().split(",")]
    elif isinstance(spec, _torch.device):
        spec = [spec]
    devices = tuple(_checked(d) for d in spec)
    if not devices:
        raise ValueError("no device given")
    # an unnamed card in a list is the current one
    devices = tuple(_torch.device("cuda", _torch.cuda.current_device())
                    if d.type == "cuda" and d.index is None else d for d in devices)
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh mixes the CPU and cards: {','.join(map(str, devices))}")
    if ranks:
        import torch.distributed as dist

        if len(devices) > 1:
            raise RuntimeError(f"a rank holds one device, not {','.join(map(str, devices))}: "
                               f"a mesh of several devices is -Pdevice=<list> without torchrun")
        if devices[0].type == "cpu" and dist.get_backend() != "gloo":
            raise RuntimeError(f"a rank runs on the CPU only under gloo, not "
                               f"{dist.get_backend()}")
        if devices[0].type == "cuda" and devices[0].index != _torch.cuda.current_device():
            raise RuntimeError(f"this rank's card is cuda:{_torch.cuda.current_device()}, "
                               f"not {devices[0]}")
    return devices
