"""Peak device memory allocated over the window (``max_memory_allocated``
after a reset at its start), in GiB."""


def read(ctx):
    if ctx.get("kind") != "train" or "window_peak_bytes" not in ctx:
        return None
    return ctx["window_peak_bytes"] / 2**30
