"""Host ms from the model's forward pre-hook to its forward hook (the enqueue
of one eval forward), averaged over the forwards of the traced span."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "infer" or tr is None:
        return None
    fwd = tr.spans_named("bench.forward")
    if not fwd:
        return None
    return sum(e.dur for e in fwd) / len(fwd) / 1e3
