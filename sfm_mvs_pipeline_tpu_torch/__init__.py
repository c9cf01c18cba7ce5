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


def resolve_device(device: _torch.device | str | None) -> _torch.device:
    """The device an entry point runs on: `device` when given, else the
    card (default_device)."""
    return _torch.device(device) if device is not None else default_device()
