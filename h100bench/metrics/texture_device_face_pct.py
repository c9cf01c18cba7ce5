"""Share of the mesh's faces textured on a card, in %: the program's
counter "texture device faces" (mvs/texture.py::build_texture_atlas adds
the face count where it samples on a CUDA device) over its counter
"texture faces" (the same count at every call). None where "texture faces"
is missing or 0: a program without the counters, or a window in which no
mesh was textured."""

from h100bench.metrics._program import counter


def read(ctx: dict) -> float | None:
    n = counter("texture faces")
    return None if not n else 100.0 * (counter("texture device faces") or 0) / n
