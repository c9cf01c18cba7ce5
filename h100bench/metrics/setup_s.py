"""Process start to the first timed set: imports, CUDA init, kernel load,
inputs, the scene a dense job resumes from, and the warm job."""


def read(ctx: dict) -> float:
    return ctx["setup_s"]
