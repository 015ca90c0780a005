"""Device kernel ms per train step in the traced span."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None or not tr.kernels:
        return None
    n = len(tr.spans_named("bench.step"))
    return sum(e.dur for e in tr.kernels) / n / 1e3 if n else None
