"""K1 and K1x, the batched 2-NN matchers: wrappers around
csrc/match_kernel.cu (K1: fp32 FMAs for float32 descriptors, bf16 tensor
cores for bfloat16 ones) and csrc/match_exact_kernel.cu (K1x, the exact
mode's bf16 hi/lo split on the tensor cores by wgmma, over each shot's
valid slots compacted to its front).

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
A launch runs under its inputs' card (a device guard and that card's current
stream), whichever card is current, and raises when its inputs do not all
lie on that card. Each wrapper counts its launches, in total (`launches`)
and a card (`by_card`), under build.py's lock.
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
EXACT_BK = 64  # K1x's operand chunk: a 64-wide hi slice beside its lo slice
EXACT_BQ = 128  # queries a K1x block owns
EXACT_MAX_D = 256  # K1x keeps a block's query operands in shared memory

def build(verbose: bool = False) -> list[str]:
    """Compile both kernel libraries if missing; returns their paths."""
    return _build.build(SOURCE, EXACT_SOURCE, verbose=verbose)


def _load(source: str, name: str, argtypes: list):
    def typed():
        fn = getattr(ctypes.CDLL(_build.build(source)[0]), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    return _build.load((source, name), typed)


def prepare_operands(descriptors: torch.Tensor, valid: torch.Tensor):
    """K1's per-shot operand prep, as its plain version computes it:
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
        err = launch(*args, torch.cuda.current_stream(descriptors.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    _build.count_launch(two_nn_batch_fused, descriptors.device)
    return idx, best, second


_build.reset_launches(two_nn_batch_fused)


def compact_slots(valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm (S, F) int64, count (S,) int32): each shot's valid slots first,
    in increasing slot order, then its invalid ones; count = its valid
    slots. One stable argsort along the slots, no host sync."""
    perm = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    return perm, valid.sum(dim=1, dtype=torch.int32)


def scatter_back(
    idx: torch.Tensor,  # (P, F) int32, compacted target index
    best: torch.Tensor,  # (P, F) f32, rows in compacted query order
    second: torch.Tensor,  # (P, F) f32
    perm: torch.Tensor,  # (S, F) int64, from compact_slots
    pairs: torch.Tensor,  # (P, 2) int32 (q_shot, t_shot)
    valid: torch.Tensor,  # (S, F) bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map K1x's compacted outputs back to slot order: idx through
    perm[t_shot], each row through perm[q_shot]. Every invalid query gets
    best^2 = second^2 = BIG and idx = 0."""
    from sfm_mvs_pipeline_tpu_torch.ops.matching import BIG

    pq, pt = pairs[:, 0].long(), pairs[:, 1].long()
    dest = perm[pq]
    idx = torch.gather(perm[pt], 1, idx.long()).to(torch.int32)
    invalid = ~valid[pq]
    return tuple(torch.empty_like(x).scatter_(1, dest, x).masked_fill_(invalid, fill)
                 for x, fill in ((idx, 0), (best, BIG), (second, BIG)))


def exact_operands(descriptors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1x's operands of descriptors (..., D) float32: (..., 2 Dp) bf16 each,
    Dp = D padded to a multiple of EXACT_BK. A holds q2 = -2 q and B holds
    t, each split into hi + lo (ops/matching.py::split_bf16) and laid out
    as EXACT_BK-wide chunks [hi_0 | lo_0 | hi_1 | lo_1 | ...], so one stage
    of the kernel brings in both parts of the same k. The kernel sums
    q2_hi.t_hi + q2_lo.t_hi + q2_hi.t_lo from them. The plain version of
    K1x's prep kernel, which builds the same bits from the compacted valid
    rows on the card: O(S F D) work amortised over the O(S^2) pair batch, as
    the JAX package builds its operands."""
    from sfm_mvs_pipeline_tpu_torch.ops.matching import split_bf16

    d = descriptors.shape[-1]
    x = torch.nn.functional.pad(descriptors, (0, -(-d // EXACT_BK) * EXACT_BK - d))

    def chunked(hi, lo):
        parts = (hi.unflatten(-1, (-1, EXACT_BK)), lo.unflatten(-1, (-1, EXACT_BK)))
        return torch.stack(parts, dim=-2).flatten(-3).to(torch.bfloat16)

    return chunked(*split_bf16(x * -2.0)), chunked(*split_bf16(x))


def two_nn_exact_batch(
    descriptors: torch.Tensor,  # (S, F, D) float32
    valid: torch.Tensor,  # (S, F) bool
    pairs: torch.Tensor,  # (P, 2) int32 (q_shot, t_shot)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1x: the exact-mode 2-NN of all pairs in one launch, the signature,
    checks and outputs of two_nn_batch_fused, for D <= EXACT_MAX_D. A CPU
    tensor takes the plain version, ops/matching.py::two_nn_exact.

    The kernel sweeps only valid slots: compact_slots moves each shot's
    valid slots to its front, the launch builds the operands of those rows
    (exact_operands' layout, in a prep kernel) and runs the 2-NN over them,
    and scatter_back maps the outputs back. Against the plain version this is
    K1's extent contract: within the stated tolerance at every valid query
    (bit-equal on integer descriptors), best^2 = BIG at every invalid query,
    and equal ratio-test masks."""
    if descriptors.device.type == "cpu":
        from sfm_mvs_pipeline_tpu_torch.ops.matching import two_nn_batch, two_nn_exact

        return two_nn_batch(descriptors, valid, pairs, nn=two_nn_exact)
    _check("K1x", descriptors, valid, pairs, bq=EXACT_BQ)
    s, f, d = descriptors.shape
    if d > EXACT_MAX_D:
        raise ValueError(f"K1x takes D <= {EXACT_MAX_D}, got {d}")
    p = pairs.shape[0]
    idx = torch.empty((p, f), dtype=torch.int32, device=descriptors.device)
    best = torch.empty((p, f), dtype=torch.float32, device=descriptors.device)
    second = torch.empty((p, f), dtype=torch.float32, device=descriptors.device)
    if p == 0:
        return idx, best, second
    perm, count = compact_slots(valid)
    dp = -(-d // EXACT_BK) * EXACT_BK
    # the kernel gathers the compacted rows into these (exact_operands'
    # layout, EXACT_BQ zero rows past the last shot) before the 2-NN
    a = torch.empty((s * f + EXACT_BQ, 2 * dp), dtype=torch.bfloat16, device=descriptors.device)
    b = torch.empty_like(a)
    norm = torch.empty(s * f, dtype=torch.float32, device=descriptors.device)
    launch = _load(EXACT_SOURCE, "two_nn_exact_launch",
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] + [ctypes.c_void_p] * 4)
    with torch.cuda.device(descriptors.device):
        err = launch(
            descriptors.data_ptr(), perm.data_ptr(), count.data_ptr(), s, f, d, dp, a.data_ptr(),
            b.data_ptr(), norm.data_ptr(), pairs.data_ptr(), p, idx.data_ptr(), best.data_ptr(),
            second.data_ptr(), torch.cuda.current_stream(descriptors.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1x launch failed: cudaError {err}")
    _build.count_launch(two_nn_exact_batch, descriptors.device)
    return scatter_back(idx, best, second, perm, pairs, valid)


_build.reset_launches(two_nn_exact_batch)


def exact_smem(d: int) -> int:
    """Dynamic shared memory a K1x block takes at width D, in bytes, as its
    launch computes it (0 for a width it does not take); builds K1x."""
    dp = -(-d // EXACT_BK) * EXACT_BK
    return _load(EXACT_SOURCE, "two_nn_exact_smem", [ctypes.c_int, ctypes.c_void_p])(dp, None)
