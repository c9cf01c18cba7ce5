"""K1 and K1x, the batched 2-NN matchers: wrappers around
csrc/match_kernel.cu (K1: fp32 FMAs for float32 descriptors, bf16 tensor
cores for bfloat16 ones) and csrc/match_exact_kernel.cu (K1x, the exact
mode's bf16x3 split on the tensor cores).

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
F32_BK = 16  # K1's fp32 route takes widths in multiples of this
BF16_BK = 64  # ... its bf16 route in multiples of this,
BF16_MAX_D = 512  # up to this (the queries' rows stay in shared memory)
BQ = 128  # queries a block of either K1 route owns

_libs: dict = {}


def build(verbose: bool = False) -> list[str]:
    """Compile both kernel libraries if missing; returns their paths."""
    return _build.build(SOURCE, EXACT_SOURCE, verbose=verbose)


def _load(source: str, name: str, argtypes: list):
    if (source, name) not in _libs:
        lib = ctypes.CDLL(_build.build(source)[0])
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[(source, name)] = fn
    return _libs[(source, name)]


def prepare_operands(descriptors: torch.Tensor, valid: torch.Tensor):
    """Per-shot operand prep, shared by the kernels and the plain version:
    |x|^2 per feature (S, F) in float32 and the target norms with invalid
    slots at BIG (S, F) — O(S) work amortised over the O(S^2) pair batch.
    bfloat16 descriptors are squared and summed in float32, a shot at a
    time, as the plain version upcasts them."""
    from sfm_mvs_pipeline_tpu_torch.ops.matching import BIG

    if descriptors.dtype == torch.float32:
        n = torch.sum(descriptors * descriptors, dim=-1)
    else:
        n = torch.stack([torch.sum(x.float() * x.float(), dim=-1) for x in descriptors])
    return n, torch.where(valid, n, torch.full_like(n, BIG))


def valid_extent(valid: torch.Tensor) -> torch.Tensor:
    """ext (S,) int32: 1 + the index of the last valid slot of each shot, 0
    for a shot with none. One device op, no host sync."""
    s, f = valid.shape
    if f == 0:
        return torch.zeros(s, dtype=torch.int32, device=valid.device)
    slots = torch.arange(1, f + 1, dtype=torch.int32, device=valid.device)
    return (valid * slots).amax(dim=1).to(torch.int32)


def _check(name: str, descriptors: torch.Tensor, valid: torch.Tensor, pairs: torch.Tensor,
           dtypes: tuple = (torch.float32,), bq: int = BQ):
    """The operand checks K1 and K1x share (CUDA tensors only); `bq` is
    the kernel's queries a block (the grid's second axis)."""
    if descriptors.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {descriptors.device}")
    if descriptors.dtype not in dtypes or descriptors.dim() != 3:
        raise ValueError(
            f"descriptors must be (S, F, D) {' or '.join(str(t) for t in dtypes)}, got "
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
    if f >= bq * 65535:
        raise ValueError(f"feature capacity {f} exceeds the kernel's grid")


def two_nn_batch_fused(
    descriptors: torch.Tensor,  # (S, F, D) float32, or bfloat16 (the +-1 expansion)
    valid: torch.Tensor,  # (S, F) bool
    pairs: torch.Tensor,  # (P, 2) int32 (q_shot, t_shot)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: all pairs in one launch. Returns (best_idx (P, F) int32,
    best_sq (P, F) f32, second_sq (P, F) f32), the contract of the JAX
    package's two_nn_batch_fused with the stricter lowest-index tie rule.

    The route follows the descriptors' type alone: float32 takes fp32 FMAs,
    bfloat16 the tensor cores (bf16 products, fp32 sums). Both sweep each
    shot only up to its valid extent (valid_extent), so against the plain
    version (ops/matching.py::two_nn_batch) the outputs are:
      * bit-equal at every valid query (on bfloat16, wherever the fp32
        sums are exact, as on +-1 descriptors: every partial sum is an
        integer of at most 2 D);
      * best_sq = BIG at every invalid query;
      * so the ratio-test masks are equal everywhere. idx and second_sq
        differ only at queries of 128-query blocks wholly past their shot's
        extent, which no caller reads (ratio_test_mask needs a valid query)."""
    if descriptors.device.type == "cpu":
        from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch

        return two_nn_batch(descriptors, valid, pairs)
    _check("K1", descriptors, valid, pairs, (torch.float32, torch.bfloat16))
    s, f, d = descriptors.shape
    p = pairs.shape[0]
    bf16 = descriptors.dtype == torch.bfloat16
    if bf16 and d > BF16_MAX_D:
        raise ValueError(f"K1's bf16 route takes D <= {BF16_MAX_D}, got {d}")
    qn, tn = prepare_operands(descriptors, valid)
    ext = valid_extent(valid)
    bk = BF16_BK if bf16 else F32_BK
    dp = -(-d // bk) * bk  # zero columns add exact zeros to every dot
    idx = torch.empty((p, f), dtype=torch.int32, device=descriptors.device)
    best = torch.empty((p, f), dtype=torch.float32, device=descriptors.device)
    second = torch.empty((p, f), dtype=torch.float32, device=descriptors.device)
    if p == 0:
        return idx, best, second
    outs = (ext.data_ptr(), pairs.data_ptr(), f, dp, p, idx.data_ptr(), best.data_ptr(),
            second.data_ptr())
    if bf16:
        ops = descriptors if dp == d else torch.nn.functional.pad(descriptors, (0, dp - d))
        launch = _load(SOURCE, "two_nn_bf16_launch",
                       [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
        args = (ops.data_ptr(), qn.data_ptr(), tn.data_ptr(), valid.data_ptr(), *outs)
    else:
        # k-major (S, Dp, Fp) with Fp a multiple of 4: the kernel stages 4
        # features of one dim a 16-byte copy
        fp = -(-f // 4) * 4
        ops = torch.nn.functional.pad(descriptors.transpose(1, 2), (0, fp - f, 0, dp - d))
        ops = ops.contiguous()
        launch = _load(SOURCE, "two_nn_f32_launch",
                       [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
        args = (ops.data_ptr(), fp, qn.data_ptr(), tn.data_ptr(), valid.data_ptr(), *outs)
    with torch.cuda.device(descriptors.device):
        err = launch(*args, torch.cuda.current_stream().cuda_stream)
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
    _check("K1x", descriptors, valid, pairs, bq=64)
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
