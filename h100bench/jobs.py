"""One image set through the program: one call of the port's CLI entry,
in-process, as a user's `photogrammetrie-torch` call runs it.

The CLI's log goes to a file beside the set's outputs; the call ends with a
synchronise of the card, so a set's time holds all its device work.
"""

from __future__ import annotations

import contextlib
import os
import time


def argv_of(kind: str, config: dict, out: str, image_dir: str, scene: str | None,
            device: str) -> list[str]:
    """The CLI's arguments for a `kind` job ("sparse": from the images, the
    configuration's flags less its dense ones; "dense": resumed from
    `scene`, all of its flags), pinned to `device`."""
    flags = config["flags"]
    if kind == "sparse":
        job = [f"-Pimage={image_dir}", *[a for a in flags if a not in config["dense_flags"]]]
    elif kind == "dense":
        job = [f"-Presume={scene}", *flags]
    else:
        raise ValueError(f"unknown job kind {kind!r}")
    return ["-Prun=photogrammetrie", *job, f"-Pout={out}", f"-Pdevice={device}"]


def run_cli(argv: list[str], log_path: str, device: str) -> tuple[int, float]:
    """(exit code, wall s) of the CLI on argv, its log written to log_path."""
    import torch

    from sfm_mvs_pipeline_tpu_torch.cli.app import main

    t0 = time.perf_counter()
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        rc = main(argv)
    if device.startswith("cuda"):
        torch.cuda.synchronize(torch.device(device))
    return rc, time.perf_counter() - t0


def log_tail(log_path: str, n: int = 2000) -> str:
    if not os.path.exists(log_path):
        return ""
    with open(log_path, errors="replace") as f:
        return f.read()[-n:]
