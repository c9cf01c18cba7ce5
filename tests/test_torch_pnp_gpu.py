"""PnP's CUDA graph route on the card (ops/pnp.py::_gn_polish): the
Gauss-Newton step captured once a solve and replayed for each of its
steps, held bit for bit to the eager loop of the same step function on the
same card, from the same uniform draws: pose, inlier mask and ratio.

Planar and non-planar maps, one step and ten, 120 and 5,000 points with
20% outliers; one solve captured and replayed under torch.profiler with
CUDA activity, as the benchmark's traced runs do; solves of different
sizes one after another, each capturing its own graph and releasing it.
The eager loop is taken by stubbing the engage rule. This file imports no
JAX, so on the card it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_pnp_gpu.py
"""

import pytest
import torch

from sfm_mvs_pipeline_tpu_torch.models.cameras import project_points
from sfm_mvs_pipeline_tpu_torch.ops import pnp as P
from sfm_mvs_pipeline_tpu_torch.utils import stage_timer
from sfm_mvs_pipeline_tpu_torch.utils.step_graph import StepGraph


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _problem(dev, planar: bool, n: int, seed=0):
    """n points 8 m ahead of a 1080p camera with radial distortion, 0.3 px
    of noise, the first 20% replaced by outliers; float32 on `dev`, as the
    SfM runs, with the RANSAC's uniform draws."""
    g = torch.Generator().manual_seed(seed)
    f64 = {"generator": g, "dtype": torch.float64}
    X = torch.rand(n, 3, **f64) * 4 - 2 + torch.tensor([0, 0, 8.0])
    if planar:
        X[:, 2] = 8.0
    intr = torch.tensor([1680.0, 960.0, 540.0, -0.05, 0.01, 0.0, 0.0], dtype=torch.float64)
    pose = torch.cat([torch.randn(3, **f64) * 0.1,
                      torch.tensor([0.3, -0.1, 0.5], dtype=torch.float64)])
    uv = project_points(pose, intr, X)[0] + torch.randn(n, 2, **f64) * 0.3
    n_out = n // 5
    uv[:n_out] = torch.rand(n_out, 2, **f64) * torch.tensor([1920.0, 1080.0])
    draws = (torch.rand(128, 6, **f64).to(dev), torch.rand(64, 4, **f64).to(dev))
    args = [t.to(dev, torch.float32) for t in (X, uv, intr)]
    return (draws, *args, torch.ones(n, dtype=torch.bool, device=dev)), pose


def _solve(problem, gn_iters, graphed, monkeypatch):
    """solve_pnp_ransac on the graph route or the eager one, with its
    "pnp solves", "pnp gn steps" and "pnp graph steps" counters."""
    monkeypatch.setattr(P, "_graph_engages", lambda *a: graphed)
    stage_timer.enable()
    try:
        out = P.solve_pnp_ransac(*problem, 4.0, gn_iters=gn_iters)
        out = tuple(t.cpu() for t in out)
    finally:
        stage_timer.enable(False)
    counted = stage_timer.counters()
    return out, tuple(counted.get(k) for k in ("pnp solves", "pnp gn steps", "pnp graph steps"))


def _assert_same_bits(got, want) -> None:
    for name, g, w in zip(("pose", "mask", "ratio"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("n", [120, 5000])
@pytest.mark.parametrize("gn_iters", [1, 10])
@pytest.mark.parametrize("planar", [False, True])
def test_graph_route_equals_the_eager_loop(planar, gn_iters, n, monkeypatch):
    dev = _card()
    problem, truth = _problem(dev, planar, n)
    eager, c_eager = _solve(problem, gn_iters, False, monkeypatch)
    graph, c_graph = _solve(problem, gn_iters, True, monkeypatch)
    assert c_eager == (1, gn_iters, None)
    assert c_graph == (1, gn_iters, gn_iters)
    _assert_same_bits(graph, eager)
    assert float(graph[2]) > 0.75  # the outliers out, the rest in
    assert torch.allclose(graph[0].double(), truth, atol=0.05)


@pytest.mark.gpu
def test_graph_route_under_the_profiler(monkeypatch):
    """Captured and replayed while torch.profiler records CUDA activity:
    the same bits, and the replays' kernels in the trace."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    problem, _ = _problem(dev, False, 3000, seed=1)
    eager, _ = _solve(problem, 10, False, monkeypatch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph, counted = _solve(problem, 10, True, monkeypatch)
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0]
    assert counted == (1, 10, 10)
    _assert_same_bits(graph, eager)
    assert len(kernels) > 100 * 10  # each replay's ~350 kernels are traced


@pytest.mark.gpu
def test_each_solve_captures_and_releases_its_graph(monkeypatch):
    """Solves of 120 and 5,000 points in turn: each captures a graph of its
    own and releases it and its pool, so the card's reserved memory
    repeats from one round to the next."""
    dev = _card()
    problems = [_problem(dev, False, n, seed=2)[0] for n in (120, 5000)]
    captured = []
    capture = StepGraph._capture

    def recorded(self):
        captured.append(self)
        capture(self)

    monkeypatch.setattr(StepGraph, "_capture", recorded)
    reserved = []
    for _ in range(3):
        for problem in problems:
            _, counted = _solve(problem, 10, True, monkeypatch)
            assert counted == (1, 10, 10)
        reserved.append(torch.cuda.memory_reserved(dev))
    assert len(captured) == 6 and len({id(g) for g in captured}) == 6
    assert all(g.graph is None and g.pool is None for g in captured)
    assert reserved[-1] == reserved[1], reserved
