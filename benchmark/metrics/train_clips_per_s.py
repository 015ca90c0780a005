"""Clips of every train step completed in the window, over the window's seconds."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["clips"] / ctx["window_s"]
