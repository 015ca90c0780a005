"""Device ms of host-to-device copies per train step in the traced span (the
compact batch's upload; ``decompress_batch`` expands it on the device)."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None:
        return None
    n = len(tr.spans_named("bench.step"))
    h2d = [e.dur for e in tr.copies if "HtoD" in e.name]
    if not n or not h2d:
        return None
    return sum(h2d) / n / 1e3
