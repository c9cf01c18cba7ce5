"""Descriptor matching: batched 2-NN with the Lowe ratio test.

Port of sfm_mvs_pipeline_tpu/ops/matching.py (the reference's
cv::DescriptorMatcher::knnMatch k=2 + ratio 0.7, min match count and the
optional distinct-match filter; ref: SfM.cpp:547-570).

Distances are squared L2, |q|^2 + |t|^2 - 2 q.t, so the L2 ratio test is
`sq1 < ratio^2 * sq2`. `two_nn` here is the plain PyTorch version of the
hand-written CUDA kernel K1 (ops/kernels/match_kernel.py), which sits behind
`match_pairs_batch` exactly where the JAX package puts its Pallas kernel;
`two_nn_exact` is the plain version of K1x, the exact mode's bf16x3
tensor-core kernel (`exact=True`).

Binary (ORB) descriptors are matched as their +-1 expansion
(`expand_binary_descriptors`): |a - b|^2 = 4 * hamming, so the same kernel
ranks Hamming distances, exactly in fp32.

Tie rule (plain version and kernel alike): the lowest target index wins —
argmin takes the first minimum, and the second distance is the minimum of
the row with that one column masked out.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 3.0e38  # invalid-target distance; ratio_test_mask tests best < BIG

# bytes of (chunk, F, F) f32 distance matrices the plain batched version
# materialises at once (one pair at F = 32768 is 4 GB and still runs alone)
_PLAIN_CHUNK_BYTES = 1 << 31


def expand_binary_descriptors(desc_u8: torch.Tensor) -> torch.Tensor:
    """uint8 binary descriptors (..., B) -> +-1 float32 (..., 8B), bits in
    little-endian order (bit i of byte j is element 8j + i), the JAX
    package's `unpackbits(..., bitorder="little")`."""
    shifts = torch.arange(8, device=desc_u8.device, dtype=torch.uint8)
    bits = (desc_u8[..., None] >> shifts) & 1
    return bits.reshape(*desc_u8.shape[:-1], -1).to(torch.float32) * 2.0 - 1.0


def packbits_little(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8B) 0/1 -> packed uint8 (..., B), little-endian within each
    byte (numpy's `packbits(..., bitorder="little")`)."""
    b = bits.to(torch.uint8).reshape(*bits.shape[:-1], -1, 8)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32, device=bits.device)
    return (b.to(torch.int32) * weights).sum(dim=-1).to(torch.uint8)


def _sq_distance_matrix(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (..., Fq, Ft) via the matmul identity."""
    qf = desc_q.float()
    tf = desc_t.float()
    qn = torch.sum(qf * qf, dim=-1)
    tn = torch.sum(tf * tf, dim=-1)
    dot = qf @ tf.transpose(-1, -2)
    d = qn[..., :, None] + tn[..., None, :] - 2.0 * dot
    return torch.clamp(d, min=0.0)


def two_nn(
    desc_q: torch.Tensor,  # (..., Fq, D)
    desc_t: torch.Tensor,  # (..., Ft, D)
    valid_q: torch.Tensor,  # (..., Fq) bool
    valid_t: torch.Tensor,  # (..., Ft) bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain 2-NN: (best_idx (..., Fq) int32, best_sq, second_sq) — the
    contract of the JAX package's two_nn_jnp."""
    d = _sq_distance_matrix(desc_q, desc_t)
    d = torch.where(valid_t[..., None, :], d, torch.full_like(d, BIG))
    idx = torch.argmin(d, dim=-1, keepdim=True)
    best = torch.gather(d, -1, idx)[..., 0]
    second = torch.amin(d.scatter(-1, idx, float("inf")), dim=-1)
    best = torch.where(valid_q, best, torch.full_like(best, BIG))
    return idx[..., 0].to(torch.int32), best, second


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = bf16(x) and lo = bf16(x - hi), both as float32
    tensors holding bf16 values: x = hi + lo to ~2^-16 relative."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def two_nn_exact(
    desc_q: torch.Tensor,  # (..., Fq, D) float32
    desc_t: torch.Tensor,  # (..., Ft, D) float32
    valid_q: torch.Tensor,  # (..., Fq) bool
    valid_t: torch.Tensor,  # (..., Ft) bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1x, the exact-mode 2-NN (the JAX package's
    `two_nn_pallas(exact=True)` on its TPU). q2 = -2 q and t are split into
    bf16 hi + lo; dot = q2_hi.t_hi + q2_lo.t_hi + q2_hi.t_lo (each product
    exact in fp32, the q2_lo.t_lo term, O(2^-16) relative, dropped); targets
    rank by |t|^2 + dot (BIG for an invalid target) with the lowest index
    winning a tie, and |q|^2 is added back after the ranking. Returns
    (best_idx int32, best_sq, second_sq), the contract of `two_nn`."""
    qf, tf = desc_q.float(), desc_t.float()
    qn = torch.sum(qf * qf, dim=-1)
    tn = torch.where(valid_t, torch.sum(tf * tf, dim=-1), torch.full_like(valid_t, BIG, dtype=torch.float32))
    q_hi, q_lo = split_bf16(qf * -2.0)
    t_hi, t_lo = split_bf16(tf)
    t_hi_t, t_lo_t = t_hi.transpose(-1, -2), t_lo.transpose(-1, -2)
    dot = q_hi @ t_hi_t + q_lo @ t_hi_t + q_hi @ t_lo_t
    score = tn[..., None, :] + dot
    idx = torch.argmin(score, dim=-1, keepdim=True)
    best = torch.gather(score, -1, idx)[..., 0]
    second = torch.amin(score.scatter(-1, idx, float("inf")), dim=-1)
    best = torch.clamp(best + qn, min=0.0)
    best = torch.where(valid_q, best, torch.full_like(best, BIG))
    second = torch.clamp(second + qn, min=0.0)
    return idx[..., 0].to(torch.int32), best, second


def two_nn_batch(
    descriptors: torch.Tensor,  # (S, F, D)
    valid: torch.Tensor,  # (S, F) bool
    pairs: torch.Tensor,  # (P, 2) int
    nn=two_nn,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain batched 2-NN (`nn`: two_nn, or two_nn_exact) over a pair table,
    chunked over pairs so the (chunk, F, F) distance matrices stay within
    _PLAIN_CHUNK_BYTES."""
    s, f, _ = descriptors.shape
    pairs = pairs.long()
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(f * f * 4, 1))
    outs = []
    for c in range(0, pairs.shape[0], chunk):
        pq, pt = pairs[c : c + chunk, 0], pairs[c : c + chunk, 1]
        outs.append(nn(descriptors[pq], descriptors[pt], valid[pq], valid[pt]))
    if not outs:
        dev = descriptors.device
        empty = torch.empty((0, f), device=dev)
        return torch.empty((0, f), dtype=torch.int32, device=dev), empty, empty
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def ratio_test_mask(
    best_sq: torch.Tensor,
    second_sq: torch.Tensor,
    valid_q: torch.Tensor,
    ratio: float = 0.7,
) -> torch.Tensor:
    """Lowe ratio on squared distances: d1 < ratio^2 * d2
    (ref ratio 0.7 on unsquared distances)."""
    return (best_sq < (ratio * ratio) * second_sq) & valid_q & (best_sq < BIG)


def distinct_filter(best_idx: torch.Tensor, match_mask: torch.Tensor) -> torch.Tensor:
    """Drop matches whose target index is claimed by more than one query
    (ref SfM.cpp:547-564) as an O(F) count per row. Works on (F,) or a
    written-out batch (..., F); the count buffer has the query capacity F,
    which is also the target capacity."""
    idx = best_idx.long()
    counts = torch.zeros(match_mask.shape, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(-1, idx, match_mask.to(torch.int32))
    claimed_once = torch.gather(counts, -1, idx) == 1
    return match_mask & claimed_once


def match_pairs_batch(
    descriptors: torch.Tensor,  # (S, F, D) float32, or bfloat16 +-1
    valid: torch.Tensor,  # (S, F) bool
    pairs: torch.Tensor,  # (P, 2) int32
    ratio: float = 0.7,
    distinct: bool = False,
    backend: str = "auto",
    method: str = "bf",
    with_distance: bool = False,
    exact: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Match every (q_shot, t_shot) row of `pairs` in one kernel launch.

    Returns (best_idx (P, F) int32, mask (P, F) bool[, best L2 distance
    (P, F)]). The default runs K1, whose route follows the descriptors'
    type: float32 (SIFT) on fp32 FMAs, bfloat16 (ORB's +-1 expansion, as
    sfm/incremental.py passes it) on the tensor cores, bit-equal to the
    float32 route since every +-1 sum is an exact integer. `exact=True` runs
    K1x, the bf16x3 split on the tensor cores, on float32 descriptors;
    callers matching binary descriptors keep `exact` False, as the JAX
    package sends its bf16 +-1 expansion to the fused kernel whatever
    `exact` says. `method="flann"` takes the JAX
    package's TPU branch on every device: the exact brute-force kernel, not
    the approximate shortlist (`two_nn_approx`, not ported), since the
    shortlist still sweeps a full (F, F) low-dimensional distance matrix and
    adds a top-32 selection per query."""
    if backend != "auto":
        raise NotImplementedError(f"matcher backend {backend!r}: the port has one backend, "
                                  f"'auto' (its kernels, or their plain versions on the CPU)")
    if method not in ("bf", "flann"):
        raise ValueError(f"unknown matcher method {method!r} (expected bf|flann)")
    from sfm_mvs_pipeline_tpu_torch.ops.kernels.match_kernel import (
        two_nn_batch_fused,
        two_nn_exact_batch,
    )

    kernel = two_nn_exact_batch if exact else two_nn_batch_fused
    best_idx, best_sq, second_sq = kernel(
        descriptors.contiguous(), valid.contiguous(), pairs.to(torch.int32).contiguous()
    )
    vq = valid[pairs[:, 0].long()]  # (P, F)
    mask = ratio_test_mask(best_sq, second_sq, vq, ratio)
    if distinct:
        mask = distinct_filter(best_idx, mask)
    if with_distance:
        return best_idx, mask, torch.sqrt(torch.clamp(best_sq, min=0.0))
    return best_idx, mask


def min_match_count_filter(pair_masks: torch.Tensor, min_count: int = 20) -> torch.Tensor:
    """Per-pair validity: at least min_count surviving matches
    (ref `-Pmatch-threshold` default 20; SfM.cpp:566-570)."""
    return torch.sum(pair_masks, dim=-1) >= min_count


def matches_to_numpy(best_idx: np.ndarray, mask: np.ndarray) -> list[np.ndarray]:
    """One pair's fixed-capacity match arrays as a compact (M, 2)
    [queryIdx, trainIdx] list per pair — host-side helper for exports."""
    out = []
    for bi, m in zip(best_idx, mask):
        q = np.nonzero(m)[0]
        out.append(np.stack([q, bi[q]], axis=1).astype(np.int32))
    return out
