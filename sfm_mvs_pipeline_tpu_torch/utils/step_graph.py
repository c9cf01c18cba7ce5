"""A solver's step as one CUDA graph: captured at the first call, replayed
at every call. Bundle adjustment's LM iteration (sfm/ba.py::lm_solve) and
PnP's Gauss-Newton step (ops/pnp.py::solve_pnp_ransac) run this way on a
CUDA card, so an iteration costs the host one replay instead of the
hundreds of small launches the step issues eagerly.

A step updates static device tensors in place and reads nothing on the
host; the graph replays its launches on the same tensors.
"""

from __future__ import annotations

import functools

import torch


class StepGraph:
    """`step` as one CUDA graph on card `dev`: captured at the first call
    into a memory pool of its own, replayed at every call. `warm()` makes,
    eagerly on the capture stream, the cuBLAS and cuSOLVER handles and
    workspaces the step's solver uses, which a capture may not create.
    close() releases the graph, and dropping the pool returns its memory
    to the card (a graph's default pool would stay reserved)."""

    def __init__(self, step, dev, warm):
        self.step, self.dev, self.warm = step, dev, warm
        self.graph = self.pool = None

    def __call__(self) -> None:
        with torch.cuda.device(self.dev):
            if self.graph is None:
                self._capture()
            self.graph.replay()

    def _capture(self) -> None:
        """Record the launches of one call of the step on a side stream;
        capturing runs none of them. Not torch.cuda.graph(...): its entry
        synchronises and empties the allocator's cache, once a solve."""
        stream = capture_stream(torch.cuda.current_device())
        self.pool, self.graph = torch.cuda.MemPool(), torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            # this thread's handles and this stream's workspaces are made
            # eagerly, outside the capture and its pool
            self.warm()
            self.graph.capture_begin(pool=self.pool.id, capture_error_mode="thread_local")
            try:
                self.step()
            finally:
                self.graph.capture_end()

    def close(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.pool = None


@functools.lru_cache(maxsize=None)
def capture_stream(index: int) -> torch.cuda.Stream:
    """The side stream that captures steps on card `index`, one a card, so
    its cuBLAS workspace is made once."""
    with torch.cuda.device(index):
        return torch.cuda.Stream()
