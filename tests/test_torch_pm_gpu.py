"""The port's rectified PatchMatch on the card (K3 scoring every candidate)
against h100bench/plain_pm.py on the same card, at 1080p for one pair.

The pair is tests/test_torch_pm_plain.py's slanted textured plane at
1920x1080, f = 1680, the cameras 0.5 apart with small yaws (disparities
~140-190 px), the depth range 3-8 and max_disp 512, 8 iterations, the
uniform draws made on the card and handed to both sides. With the port's
window statistics handed to the reference the two are bit-equal; with the
reference's own, the tolerance is the CPU tests' (>= 95% of the pixels
agreeing on validity and >= 95% of the depths within 1% where both are
valid), and scoring in bfloat16 fails it. This file imports no JAX, so on
the card it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_pm_gpu.py
"""

import pytest
import torch

from h100bench import plain_pm as R
from sfm_mvs_pipeline_tpu_torch.mvs import patchmatch as TPM
from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import window_stats
from tests.test_torch_pm_plain import DEPTH_AGREE, VALID_AGREE, scene

pytestmark = pytest.mark.gpu

H, W, F = 1080, 1920, 1680.0
IT, MD = 8, 512


@pytest.fixture(scope="module")
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    imgs, poses, intr = scene([[0, 0, 0], [0.5, 0.01, 0]], [0.0, 0.01], h=H, w=W, f=F)
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand():
        return torch.rand((H, W), generator=gen, device=dev)

    draws = (rand(), [(rand(), rand()) for _ in range(2 * IT)])
    args = (imgs[0].to(dev), imgs[1].to(dev), poses[0].to(dev), poses[1].to(dev), intr.to(dev),
            3.0, 8.0)
    port = TPM._pm_rect_pair(*args, draws=draws, iterations=IT, window_radius=3, max_cost=0.35,
                             max_disp=MD)
    return args, draws, port


def plain(pair, **extra):
    args, draws, _ = pair
    return R.pm_rect_pair(*args, draws, iterations=IT, window_radius=3, max_cost=0.35,
                          max_disp=MD, **extra)


def test_bit_equal_with_the_programs_window_statistics(pair):
    port = pair[2]
    assert port[0].is_cuda
    ref = plain(pair, stats=window_stats)
    assert all(torch.equal(a, b) for a, b in zip(port, ref))


def test_within_tolerance_of_the_plain_reference(pair):
    port = pair[2]
    got = R.compare(port[0], port[2], *plain(pair)[::2])
    assert got["both_valid"] > 0.5, got
    assert got["valid_agree"] >= VALID_AGREE and got["depth_agree"] >= DEPTH_AGREE, got


def test_bfloat16_scoring_fails_the_comparison(pair):
    port = pair[2]
    got = R.compare(port[0], port[2], *plain(pair, score_dtype=torch.bfloat16)[::2])
    assert got["depth_agree"] < 0.5 * DEPTH_AGREE, got
