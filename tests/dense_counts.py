"""The dense stage's counts, step by step, of the JAX package and of the
port on the 12-view render (utils/synth.py) cut to 480x270 (f = 420), on
the CPU: valid pixels of each view's depth map, fused points, and mesh
faces after each step of mvs/mesh.py::mesh_from_depth_maps
(back-projection, cluster_vertices, remove_small_components,
close_holes, smoothing), for --sgm and for PatchMatch resumed from the
--sgm run's scene.npz (the JAX package's warp-based PatchMatch on its CPU
path, the port's rectified PatchMatch).

    JAX_PLATFORMS=cpu python -m tests.dense_counts [--out DIR]

Both CLIs run in this process (the JAX package's with its mesh steps
wrapped to log their counts, the port's with -Pdevice=cpu); prints one
line a run. Takes ~10 min.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import tempfile


def _counts(log: str) -> dict:
    # the JAX package logs no depth range
    pattern = r"\] view (\d+): (?:depth range .*?, )?(\d+)/\d+ valid px"
    valid = [n for _, n in sorted((int(v), int(n)) for v, n in re.findall(pattern, log))]
    fused = re.findall(r"fused dense cloud: (\d+) points", log)
    steps = ["raw mesh", "clustered", "small components removed", "holes closed", "cleaned"]
    faces = {k: int(re.findall(re.escape(k) + r": \d+ verts, (\d+) faces", log)[-1])
             for k in steps}
    return {"valid_px": valid, "valid_sum": sum(valid), "fused": int(fused[-1]), "faces": faces}


def _run(main, argv: list[str]) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{argv} exited {rc}:\n{buf.getvalue()[-3000:]}")
    return buf.getvalue()


@contextlib.contextmanager
def _jax_mesh_steps_logged(log):
    """The JAX package's mesh_from_depth_maps with its two unlogged steps
    wrapped to pass their counts to log(msg), as the port logs them."""
    from sfm_mvs_pipeline_tpu.mvs import mesh as M

    orig = M.remove_small_components, M.close_holes

    def logged(fn, what):
        def wrapped(*a, **k):
            V, F, C = fn(*a, **k)
            log(f"{what}: {len(V)} verts, {len(F)} faces")
            return V, F, C
        return wrapped

    M.remove_small_components = logged(orig[0], "small components removed")
    M.close_holes = logged(orig[1], "holes closed")
    try:
        yield
    finally:
        M.remove_small_components, M.close_holes = orig


def main() -> int:
    from sfm_mvs_pipeline_tpu.cli.app import main as j_main
    from sfm_mvs_pipeline_tpu.utils import logger as logging
    from sfm_mvs_pipeline_tpu_torch.cli.app import main as t_main
    from sfm_mvs_pipeline_tpu_torch.utils.synth import render_views

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="work dir (default: a temporary one)")
    args = ap.parse_args()
    work = args.out or tempfile.mkdtemp(prefix="dense_counts_")
    data = os.path.join(work, "views")
    render_views(data, 12, 270, 480, 420.0)
    for name, cli, extra in (("jax", j_main, []), ("port", t_main, ["-Pdevice=cpu"])):
        out = os.path.join(work, f"{name}-sgm")
        with _jax_mesh_steps_logged(logging.AppLogger("MVS").info):
            log = _run(cli, ["-Prun=photogrammetrie", f"-Pimage={data}", f"-Pout={out}",
                             "-Pfeature-limit=0", "--dense", "--sgm", "--mesh", *extra])
            print(f"{name} --sgm: {_counts(log)}", flush=True)
            log = _run(cli, ["-Prun=photogrammetrie", f"-Presume={out}/scene.npz",
                             f"-Pout={out}-pm", "--dense", "-Pdense-method=patchmatch",
                             "--mesh", *extra])
            print(f"{name} PatchMatch: {_counts(log)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
