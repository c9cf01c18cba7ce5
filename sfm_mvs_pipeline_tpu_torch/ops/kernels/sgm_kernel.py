"""K2a and K2b, the SGM kernels: wrappers around csrc/sgm_kernel.cu.

Counterparts of sfm_mvs_pipeline_tpu/ops/pallas/sgm_kernel.py:
  * `sgm_bidir` (K2a, TPU kernel `_sgm_kernel`): forward + backward SGM along
    one axis of an (H, W, D) volume, summed. Called on both axes it serves
    mvs/sgm.py::sgm_aggregate.
  * K2b (TPU kernel `_sgm_dir_kernel`), the memory-staged route
    `sgm_staged_hwd`, in two entries:
      `sgm_hpair`: the two horizontal directions over the f32 cost rounded
      to bf16, in one launch; returns the accumulator and the bf16 copy.
      `sgm_dir_acc`: `acc += L_r` IN PLACE for one direction of the bf16
      cost; the staged route calls it for the vertical forward, then the
      vertical backward direction.

What bounds them on the card is the bytes (volume passes at 3.35 TB/s), and
only ~3 MB in flight reach that rate. The source keeps a ring of 4 rows in
flight a warp, cost rows and the rows of acc or out a step adds to, and
runs a line's two directions at once in two warps that meet in the middle
(K2a, the horizontal pair): each writes its L over the first half of the
positions it visits and adds it to the other's over the second. a + b ==
b + a and 0 + L == L, so every result keeps the plain versions' bits
(mvs/sgm.py). csrc/sgm_kernel.cu has the details.

Build: ops/kernels/build.py compiles the source with nvcc for sm_90a at
first use and this module loads it with ctypes.

Dispatch: a CPU tensor takes the plain PyTorch version (mvs/sgm.py); a CUDA
tensor launches the kernel or raises. There is no fallback from the card to
the plain version. A launch runs under its inputs' card (a device guard and
that card's current stream), whichever card is current, and raises when its inputs do not all
lie on that card. Each wrapper counts its launches, in total (`launches`)
and a card (`by_card`), under build.py's lock.
"""

from __future__ import annotations

import ctypes

import torch

from sfm_mvs_pipeline_tpu_torch.ops.kernels import build as _build

SOURCE = "sgm_kernel.cu"
MAX_D = 256  # 8 disparities a lane of a warp

def build(verbose: bool = False) -> str:
    """Compile the kernel library if missing; returns its path."""
    return _build.build(SOURCE, verbose=verbose)[0]


def _open():
    lib = ctypes.CDLL(build())
    common = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.sgm_bidir_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *common, ctypes.c_void_p]
    lib.sgm_hpair_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     *common, ctypes.c_void_p]
    lib.sgm_dir_acc_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *common,
                                       ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.sgm_bidir_launch, lib.sgm_hpair_launch, lib.sgm_dir_acc_launch):
        fn.restype = ctypes.c_int
    return lib


def _load():
    return _build.load(SOURCE, _open)


def _geometry(v: torch.Tensor, axis: int):
    """(S, L, step, line_stride, D) of a contiguous (H, W, D) volume scanned
    along `axis`, in elements."""
    h, w, d = v.shape
    if axis == 1:
        return w, h, d, w * d, d
    if axis == 0:
        return h, w, w * d, d, d
    raise ValueError(f"scan axis must be 0 (H) or 1 (W), got {axis}")


def _check(name: str, v: torch.Tensor, dtype: torch.dtype) -> None:
    if v.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {v.device}")
    if v.dim() != 3 or v.dtype != dtype or not v.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (H, W, D) {dtype} volume, got "
                         f"{tuple(v.shape)} {v.dtype}")
    if not 1 <= v.shape[2] <= MAX_D:
        raise ValueError(f"{name} takes 1 <= D <= {MAX_D}, got {v.shape[2]}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def sgm_bidir(cost_hwd: torch.Tensor, p1: float, p2: float, axis: int) -> torch.Tensor:
    """K2a: forward + backward SGM along `axis` (0 = H, 1 = W) of a
    contiguous (H, W, D) float32 volume, summed; returns a new volume."""
    if cost_hwd.device.type == "cpu":
        from sfm_mvs_pipeline_tpu_torch.mvs.sgm import sgm_bidir_plain

        return sgm_bidir_plain(cost_hwd, p1, p2, axis)
    _check("K2a", cost_hwd, torch.float32)
    S, L, step, line, D = _geometry(cost_hwd, axis)
    out = torch.empty_like(cost_hwd)
    lib = _load()
    with torch.cuda.device(cost_hwd.device):
        stream = torch.cuda.current_stream(cost_hwd.device).cuda_stream
        err = lib.sgm_bidir_launch(cost_hwd.data_ptr(), out.data_ptr(), S, L, step, line, D,
                                   float(p1), float(p2), stream)
    _raise_on(err, "K2a")
    _build.count_launch(sgm_bidir, cost_hwd.device)
    return out


_build.reset_launches(sgm_bidir)


def sgm_hpair(cost_hwd: torch.Tensor, p1: float, p2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K2b, the staged route's horizontal pair: the contiguous (H, W, D)
    float32 cost rounded to bf16, and L_forward + L_backward along W over
    it. Returns (acc f32, the bf16 cost), both (H, W, D) and new."""
    if cost_hwd.device.type == "cpu":
        from sfm_mvs_pipeline_tpu_torch.mvs.sgm import sgm_hpair_plain

        return sgm_hpair_plain(cost_hwd, p1, p2)
    _check("K2b", cost_hwd, torch.float32)
    S, L, step, line, D = _geometry(cost_hwd, 1)
    acc = torch.empty_like(cost_hwd)
    copy = torch.empty(cost_hwd.shape, dtype=torch.bfloat16, device=cost_hwd.device)
    lib = _load()
    with torch.cuda.device(cost_hwd.device):
        stream = torch.cuda.current_stream(cost_hwd.device).cuda_stream
        err = lib.sgm_hpair_launch(cost_hwd.data_ptr(), acc.data_ptr(), copy.data_ptr(), S, L,
                                   step, line, D, float(p1), float(p2), stream)
    _raise_on(err, "K2b (horizontal pair)")
    _build.count_launch(sgm_hpair, cost_hwd.device)
    return acc, copy


_build.reset_launches(sgm_hpair)


def sgm_dir_acc(cost_hwd: torch.Tensor, acc: torch.Tensor, p1: float, p2: float,
                axis: int, reverse: bool) -> torch.Tensor:
    """K2b: acc += L_r for one direction along `axis` of the bf16 cost
    (H, W, D), IN PLACE on the f32 accumulator `acc` (H, W, D). Returns acc."""
    if cost_hwd.device.type == "cpu":
        from sfm_mvs_pipeline_tpu_torch.mvs.sgm import sgm_dir_acc_plain

        return sgm_dir_acc_plain(cost_hwd, acc, p1, p2, axis, reverse)
    _check("K2b", cost_hwd, torch.bfloat16)
    _check("K2b accumulator", acc, torch.float32)
    if acc.shape != cost_hwd.shape or acc.device != cost_hwd.device:
        raise ValueError(f"acc {tuple(acc.shape)} on {acc.device} does not match the cost "
                         f"{tuple(cost_hwd.shape)} on {cost_hwd.device}")
    S, L, step, line, D = _geometry(cost_hwd, axis)
    lib = _load()
    with torch.cuda.device(cost_hwd.device):
        stream = torch.cuda.current_stream(cost_hwd.device).cuda_stream
        err = lib.sgm_dir_acc_launch(cost_hwd.data_ptr(), acc.data_ptr(), S, L, step, line, D,
                                     float(p1), float(p2), int(reverse), stream)
    _raise_on(err, "K2b")
    _build.count_launch(sgm_dir_acc, cost_hwd.device)
    return acc


_build.reset_launches(sgm_dir_acc)


def sgm_staged_hwd(cost_hwd: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Memory-staged 4-path SGM through K2b (mvs/sgm.py::staged_sum) of a
    contiguous (H, W, D) f32 cost: returns the UNNORMALISED 4-path sum
    (H, W, D) f32; the caller divides by 4."""
    from sfm_mvs_pipeline_tpu_torch.mvs.sgm import staged_sum

    return staged_sum(cost_hwd, p1, p2, sgm_hpair, sgm_dir_acc)
