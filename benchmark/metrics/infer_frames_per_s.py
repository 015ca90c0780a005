"""Real frames (not padding) of every request whose masks reached the host
in the window, over the window's seconds."""


def read(ctx):
    if ctx.get("kind") != "infer":
        return None
    return ctx["frames"] / ctx["window_s"]
