"""K1, the batched 2-NN matcher: wrapper around csrc/match_kernel.cu.

Counterpart of sfm_mvs_pipeline_tpu/ops/pallas/match_kernel.py
(`two_nn_batch_fused`, TPU kernel `_two_nn_fused_kernel`). The CUDA source
says what bounds the kernel on the card and how its design answers that.

Build: ops/kernels/build.py compiles the source with nvcc for sm_90a at
first use and this module loads it with ctypes. Nothing is built or
imported when this module is imported.

Dispatch: a CPU tensor takes the plain PyTorch version
(ops/matching.py::two_nn_batch); a CUDA tensor launches the kernel or
raises. There is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from sfm_mvs_pipeline_tpu_torch.ops.kernels import build as _build

SOURCE = "match_kernel.cu"

_lib = None


def build(verbose: bool = False) -> str:
    """Compile the kernel library if missing; returns its path."""
    return _build.build(SOURCE, verbose=verbose)[0]


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.two_nn_batch_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def prepare_operands(descriptors: torch.Tensor, valid: torch.Tensor):
    """Per-shot operand prep, shared by the kernel and the plain version:
    |x|^2 per feature (S, F) and the target norms with invalid slots at
    BIG (S, F) — O(S) work amortised over the O(S^2) pair batch."""
    from sfm_mvs_pipeline_tpu_torch.ops.matching import BIG

    n = torch.sum(descriptors * descriptors, dim=-1)
    return n, torch.where(valid, n, torch.full_like(n, BIG))


def two_nn_batch_fused(
    descriptors: torch.Tensor,  # (S, F, D) float32
    valid: torch.Tensor,  # (S, F) bool
    pairs: torch.Tensor,  # (P, 2) int32 (q_shot, t_shot)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All pairs in one launch. Returns (best_idx (P, F) int32,
    best_sq (P, F) f32, second_sq (P, F) f32), the contract of the JAX
    package's two_nn_batch_fused with the stricter lowest-index tie rule."""
    if descriptors.device.type == "cpu":
        from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch

        return two_nn_batch(descriptors, valid, pairs)
    if descriptors.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {descriptors.device}")
    if descriptors.dtype != torch.float32 or descriptors.dim() != 3:
        raise ValueError(
            f"descriptors must be (S, F, D) float32, got "
            f"{tuple(descriptors.shape)} {descriptors.dtype}"
        )
    s, f, d = descriptors.shape
    if valid.shape != (s, f) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be ({s}, {f}) bool, got {tuple(valid.shape)} {valid.dtype}")
    if pairs.dim() != 2 or pairs.shape[1] != 2 or pairs.dtype != torch.int32:
        raise ValueError(f"pairs must be (P, 2) int32, got {tuple(pairs.shape)} {pairs.dtype}")
    for name, t in (("valid", valid), ("pairs", pairs)):
        if t.device != descriptors.device:
            raise ValueError(f"{name} is on {t.device}, descriptors on {descriptors.device}")
    if not (descriptors.is_contiguous() and valid.is_contiguous() and pairs.is_contiguous()):
        raise ValueError("K1 operands must be contiguous")
    if f >= 64 * 65535:
        raise ValueError(f"feature capacity {f} exceeds the kernel's grid")

    p = pairs.shape[0]
    qn, tn = prepare_operands(descriptors, valid)
    idx = torch.empty((p, f), dtype=torch.int32, device=descriptors.device)
    best = torch.empty((p, f), dtype=torch.float32, device=descriptors.device)
    second = torch.empty((p, f), dtype=torch.float32, device=descriptors.device)
    if p == 0:
        return idx, best, second
    lib = _load()
    with torch.cuda.device(descriptors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.two_nn_batch_launch(
            descriptors.data_ptr(), qn.data_ptr(), tn.data_ptr(),
            valid.data_ptr(), pairs.data_ptr(), f, d, p,
            idx.data_ptr(), best.data_ptr(), second.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    two_nn_batch_fused.launches += 1
    return idx, best, second


two_nn_batch_fused.launches = 0
