"""Device kernel ms of the traced span over the eval forwards it held."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "infer" or tr is None:
        return None
    n = len(tr.spans_named("bench.forward"))
    if not n or not tr.kernels:
        return None
    return sum(e.dur for e in tr.kernels) / n / 1e3
