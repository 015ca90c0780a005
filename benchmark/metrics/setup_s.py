"""Seconds from the start of the process to the start of the window: imports,
the model's build and weights, the traffic pool, the kernels' build or load,
and the warm-up (a train cell's first three steps)."""


def read(ctx):
    return ctx.get("setup_s")
