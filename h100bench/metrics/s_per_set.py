"""The window's length, from the first set's start to the last set's
finish, over the image sets finished in it (host clock; each set ends in a
synchronise of the card). Shared by `<job>_s_per_set` metrics."""


def read(ctx: dict) -> float:
    return ctx["window_s"] / ctx["sets"]
