"""K1 and K1x, the batched 2-NN matchers: wrappers around
csrc/match_kernel.cu (K1, fp32 FMAs) and csrc/match_exact_kernel.cu (K1x,
the exact mode's bf16x3 split on the tensor cores).

Counterparts of sfm_mvs_pipeline_tpu/ops/pallas/match_kernel.py: K1 of
`two_nn_batch_fused` (TPU kernel `_two_nn_fused_kernel`), K1x of
`two_nn_pallas(exact=True)` (TPU kernel `_two_nn_kernel`). Each CUDA source
says what bounds its kernel on the card and how its design answers that.

Build: ops/kernels/build.py compiles the source with nvcc for sm_90a at
first use and this module loads it with ctypes. Nothing is built or
imported when this module is imported.

Dispatch: a CPU tensor takes the plain PyTorch version
(ops/matching.py::two_nn_batch over two_nn or two_nn_exact); a CUDA tensor
launches the kernel or raises. There is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from sfm_mvs_pipeline_tpu_torch.ops.kernels import build as _build

SOURCE = "match_kernel.cu"
EXACT_SOURCE = "match_exact_kernel.cu"

_libs: dict = {}


def build(verbose: bool = False) -> list[str]:
    """Compile both kernel libraries if missing; returns their paths."""
    return _build.build(SOURCE, EXACT_SOURCE, verbose=verbose)


def _load(source: str, name: str, argtypes: list):
    if source not in _libs:
        lib = ctypes.CDLL(_build.build(source)[0])
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[source] = fn
    return _libs[source]


def prepare_operands(descriptors: torch.Tensor, valid: torch.Tensor):
    """Per-shot operand prep, shared by the kernel and the plain version:
    |x|^2 per feature (S, F) and the target norms with invalid slots at
    BIG (S, F) — O(S) work amortised over the O(S^2) pair batch."""
    from sfm_mvs_pipeline_tpu_torch.ops.matching import BIG

    n = torch.sum(descriptors * descriptors, dim=-1)
    return n, torch.where(valid, n, torch.full_like(n, BIG))


def _check(name: str, descriptors: torch.Tensor, valid: torch.Tensor, pairs: torch.Tensor):
    """The operand checks K1 and K1x share (CUDA tensors only)."""
    if descriptors.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {descriptors.device}")
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
    for arg, t in (("valid", valid), ("pairs", pairs)):
        if t.device != descriptors.device:
            raise ValueError(f"{arg} is on {t.device}, descriptors on {descriptors.device}")
    if not (descriptors.is_contiguous() and valid.is_contiguous() and pairs.is_contiguous()):
        raise ValueError(f"{name} operands must be contiguous")
    if f >= 64 * 65535:
        raise ValueError(f"feature capacity {f} exceeds the kernel's grid")


def two_nn_batch_fused(
    descriptors: torch.Tensor,  # (S, F, D) float32
    valid: torch.Tensor,  # (S, F) bool
    pairs: torch.Tensor,  # (P, 2) int32 (q_shot, t_shot)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: all pairs in one launch. Returns (best_idx (P, F) int32,
    best_sq (P, F) f32, second_sq (P, F) f32), the contract of the JAX
    package's two_nn_batch_fused with the stricter lowest-index tie rule."""
    if descriptors.device.type == "cpu":
        from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch

        return two_nn_batch(descriptors, valid, pairs)
    _check("K1", descriptors, valid, pairs)
    s, f, d = descriptors.shape
    p = pairs.shape[0]
    qn, tn = prepare_operands(descriptors, valid)
    idx = torch.empty((p, f), dtype=torch.int32, device=descriptors.device)
    best = torch.empty((p, f), dtype=torch.float32, device=descriptors.device)
    second = torch.empty((p, f), dtype=torch.float32, device=descriptors.device)
    if p == 0:
        return idx, best, second
    launch = _load(SOURCE, "two_nn_batch_launch",
                   [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    with torch.cuda.device(descriptors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            descriptors.data_ptr(), qn.data_ptr(), tn.data_ptr(),
            valid.data_ptr(), pairs.data_ptr(), f, d, p,
            idx.data_ptr(), best.data_ptr(), second.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    two_nn_batch_fused.launches += 1
    return idx, best, second


two_nn_batch_fused.launches = 0


def exact_operands(descriptors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shot operands of K1x, (S, F, 3 Dp) bf16 each with Dp the width
    padded to a multiple of 32: A = [q2_hi | q2_lo | q2_hi] with q2 = -2 q,
    B = [t_hi | t_hi | t_lo] (ops/matching.py::split_bf16), so one product
    of width 3 Dp sums q2_hi.t_hi + q2_lo.t_hi + q2_hi.t_lo. O(S F D) work
    amortised over the O(S^2) pair batch, as the JAX package builds them."""
    from sfm_mvs_pipeline_tpu_torch.ops.matching import split_bf16

    d = descriptors.shape[-1]
    dp = -(-d // 32) * 32
    x = torch.nn.functional.pad(descriptors, (0, dp - d))
    q_hi, q_lo = split_bf16(x * -2.0)
    t_hi, t_lo = split_bf16(x)
    a = torch.cat([q_hi, q_lo, q_hi], dim=-1).to(torch.bfloat16)
    b = torch.cat([t_hi, t_hi, t_lo], dim=-1).to(torch.bfloat16)
    return a.contiguous(), b.contiguous()


def two_nn_exact_batch(
    descriptors: torch.Tensor,  # (S, F, D) float32
    valid: torch.Tensor,  # (S, F) bool
    pairs: torch.Tensor,  # (P, 2) int32 (q_shot, t_shot)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1x: the exact-mode 2-NN of all pairs in one launch, the signature,
    checks and outputs of two_nn_batch_fused. A CPU tensor takes the plain
    version, ops/matching.py::two_nn_exact."""
    if descriptors.device.type == "cpu":
        from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch, two_nn_exact

        return two_nn_batch(descriptors, valid, pairs, nn=two_nn_exact)
    _check("K1x", descriptors, valid, pairs)
    s, f, d = descriptors.shape
    p = pairs.shape[0]
    qn, tn = prepare_operands(descriptors, valid)
    a, b = exact_operands(descriptors)
    idx = torch.empty((p, f), dtype=torch.int32, device=descriptors.device)
    best = torch.empty((p, f), dtype=torch.float32, device=descriptors.device)
    second = torch.empty((p, f), dtype=torch.float32, device=descriptors.device)
    if p == 0:
        return idx, best, second
    launch = _load(EXACT_SOURCE, "two_nn_exact_launch",
                   [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    with torch.cuda.device(descriptors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            a.data_ptr(), b.data_ptr(), qn.data_ptr(), tn.data_ptr(),
            valid.data_ptr(), pairs.data_ptr(), f, a.shape[-1], p,
            idx.data_ptr(), best.data_ptr(), second.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"K1x launch failed: cudaError {err}")
    two_nn_exact_batch.launches += 1
    return idx, best, second


two_nn_exact_batch.launches = 0
