"""The pair-sharded matcher in a one-rank nccl group on the card: bit-equal
to match_pairs_batch (kernel K1, and K1x with exact=True) on the same
inputs, so nccl's all_gather carries the kernel's outputs unchanged. Needs
a CUDA card (nccl refuses a second rank on one card, so the world is 1);
skipped elsewhere. This file imports no JAX, so on the card it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py
"""

import pytest
import torch

from tests.test_torch_distributed import launch_ranks

_WORKER = r"""
import numpy as np
import torch
import torch.distributed as dist
from sfm_mvs_pipeline_tpu_torch.ops.matching import match_pairs_batch
from sfm_mvs_pipeline_tpu_torch.parallel.distributed import initialize_distributed
from sfm_mvs_pipeline_tpu_torch.parallel.matching import match_pairs_sharded

initialize_distributed()
assert dist.get_backend() == "nccl", dist.get_backend()
rng = np.random.default_rng(0)
S, F, D = 5, 300, 128
d = rng.integers(0, 256, size=(S, F, D)).astype(np.float32)
for s in range(S):  # duplicated rows: exact ties
    d[s, rng.integers(0, F, F // 8)] = d[s, rng.integers(0, F, F // 8)]
v = rng.random((S, F)) > 0.1
pairs = np.array([(a, b) for a in range(S) for b in range(a + 1, S)], np.int32)
dt, vt, pt = (torch.from_numpy(x).cuda() for x in (d, v, pairs))
for exact in (False, True):
    got = match_pairs_sharded(dt, vt, pt, with_distance=True, exact=exact)
    ref = match_pairs_batch(dt, vt, pt, with_distance=True, exact=exact)
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(got, ref)), exact
print("nccl world 1 OK", flush=True)
"""


@pytest.mark.gpu
def test_match_pairs_sharded_nccl_world1_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (out,) = launch_ranks(["-c", _WORKER], 1, timeout=300)
    assert "nccl world 1 OK" in out
