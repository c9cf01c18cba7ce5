"""Share of the raw mesh soup's vertices clustered on a card, in %: the
program's counter "mesh device vertices" (mvs/mesh.py::cluster_vertices
adds the soup's vertex count where the soup is on a CUDA device) over its
counter "mesh raw vertices" (the same count at every clustering). None
where "mesh raw vertices" is missing or 0: a program without the counters,
or a window in which no mesh was clustered."""

from h100bench.metrics._program import counter


def read(ctx: dict) -> float | None:
    n = counter("mesh raw vertices")
    return None if not n else 100.0 * (counter("mesh device vertices") or 0) / n
