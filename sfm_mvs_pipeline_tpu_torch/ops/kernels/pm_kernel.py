"""K3, the rectified PatchMatch scoring kernel: wrapper around csrc/pm_kernel.cu.

Counterpart of sfm_mvs_pipeline_tpu/ops/pallas/pm_kernel.py::pm_score_rect
(TPU kernel `_pm_score_kernel`): per pixel and candidate disparity, ZNCC
over a (2r+1)^2 window, bilinear in x, in the rectified frame of one
(ref, neighbour) pair. mvs/patchmatch.py::_pm_rect_pair calls it once for
the random init (C = 1, every pixel) and once per half-iteration (C = 6,
`parity` set: the pixels of one checkerboard parity). The CUDA source says
what bounds the kernel on the card and how the design answers that.
The JAX package's x-strips for images wider than 1024 are a TPU layout
device and are not ported: the kernel takes any width.

Build: ops/kernels/build.py compiles the source with nvcc for sm_90a at
first use and this module loads it with ctypes.

Dispatch: a CPU tensor takes the plain PyTorch version
(mvs/patchmatch.py::pm_score_rect_plain); a CUDA tensor launches the kernel
or raises. There is no fallback from the card to the plain version.
A launch runs under its inputs' card (a device guard and that card's current
stream), whichever card is current, and raises when its inputs do not all
lie on that card. Each wrapper counts its launches, in total (`launches`)
and a card (`by_card`), under build.py's lock.
"""

from __future__ import annotations

import ctypes

import torch

from sfm_mvs_pipeline_tpu_torch.ops.kernels import build as _build
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer

SOURCE = "pm_kernel.cu"
MAX_R = 4  # window radii compiled into the kernel: 1..4

def build(verbose: bool = False) -> str:
    """Compile the kernel library if missing; returns its path."""
    return _build.build(SOURCE, verbose=verbose)[0]


def _open():
    lib = ctypes.CDLL(build())
    lib.pm_score_rect_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.pm_score_rect_launch.restype = ctypes.c_int
    return lib


def _load():
    return _build.load(SOURCE, _open)


def _check(cands, maps: dict, window_radius: int, maxd: int, parity) -> None:
    dev = cands.device
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {dev}")
    if cands.dim() != 3 or cands.dtype != torch.float32 or not cands.is_contiguous():
        raise ValueError(f"K3 takes contiguous (C, H, W) float32 candidates, got "
                         f"{tuple(cands.shape)} {cands.dtype}")
    hw = tuple(cands.shape[1:])
    for name, (t, dtype) in maps.items():
        if (t.device != dev or tuple(t.shape) != hw or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"K3 takes {name} as a contiguous {hw} {dtype} tensor on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not 1 <= window_radius <= MAX_R:
        raise ValueError(f"K3 takes 1 <= window_radius <= {MAX_R}, got {window_radius}")
    if maxd < 0:
        raise ValueError(f"maxd must be >= 0, got {maxd}")
    if hw[0] > 4 * 65535:
        raise ValueError(f"K3 takes H <= {4 * 65535}, got {hw[0]}")
    if parity not in (None, 0, 1):
        raise ValueError(f"parity must be None, 0 or 1, got {parity!r}")


def _count_work(shape, window_radius: int, parity) -> None:
    """Add a scoring's work to the stage timer's counters: "k3 candidate
    pixels" (candidates x active pixels), "k3 window samples" (that times
    (2r+1)^2, which carries the window radius), "k3 pixels" (H W) and "k3
    costs" (C H W, every cost written)."""
    c, h, w = shape
    n_act = h * w if parity is None else (h * w + (1 - parity)) // 2
    stage_timer.count("k3 candidate pixels", c * n_act)
    stage_timer.count("k3 window samples", c * n_act * (2 * window_radius + 1) ** 2)
    stage_timer.count("k3 pixels", h * w)
    stage_timer.count("k3 costs", c * h * w)


def pm_score_rect(
    cands: torch.Tensor,  # (C, H, W) candidate disparity maps (>= 0)
    ref_rect: torch.Tensor,  # (H, W) rectified ref image
    nbr_rect: torch.Tensor,  # (H, W) rectified neighbour
    in_n: torch.Tensor,  # (H, W) bool neighbour validity
    r_mean: torch.Tensor,  # (H, W) ref window mean
    r_var: torch.Tensor,  # (H, W) ref window variance
    maxd: int,
    window_radius: int = 3,
    parity: int | None = None,
) -> torch.Tensor:
    """K3: costs (C, H, W) float32 of C disparity candidate maps; the
    semantics are pm_score_rect_plain's (mvs/patchmatch.py), `parity`
    included: 0 or 1 scores only the pixels with (y + x) % 2 == parity and
    gives the others cost 1. On the card the wrapper zeroes the
    neighbour's invalid pixels (the plain version's own zeroing) and the
    kernel reads every tap from that copy, so a tap is one load; maxd sizes
    the kernel's staging of neighbour rows (candidates are expected in
    [0, maxd]); the costs do not depend on it. Each call adds its work to
    the stage timer's counters (_count_work), on either route."""
    if cands.device.type == "cpu":
        from sfm_mvs_pipeline_tpu_torch.mvs.patchmatch import pm_score_rect_plain

        out = pm_score_rect_plain(cands, ref_rect, nbr_rect, in_n, r_mean, r_var, maxd,
                                  window_radius, parity=parity)
        _count_work(cands.shape, window_radius, parity)
        return out
    f32 = torch.float32
    _check(cands, {"ref_rect": (ref_rect, f32), "nbr_rect": (nbr_rect, f32),
                   "in_n": (in_n, torch.bool), "r_mean": (r_mean, f32), "r_var": (r_var, f32)},
           window_radius, maxd, parity)
    nbr_rect = torch.where(in_n, nbr_rect, torch.zeros((), dtype=f32, device=cands.device))
    c, h, w = cands.shape
    out = torch.empty_like(cands)
    lib = _load()
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        err = lib.pm_score_rect_launch(
            cands.data_ptr(), ref_rect.data_ptr(), nbr_rect.data_ptr(), in_n.data_ptr(),
            r_mean.data_ptr(), r_var.data_ptr(), out.data_ptr(), c, h, w, window_radius,
            -1 if parity is None else parity, min(maxd, 1 << 20), stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    _build.count_launch(pm_score_rect, cands.device)
    _count_work(cands.shape, window_radius, parity)
    return out


_build.reset_launches(pm_score_rect)
