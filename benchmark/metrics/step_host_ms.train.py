"""Host ms per ``TrainStep.__call__`` in the traced span, less the time
blocked in CUDA synchronisation inside it."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None:
        return None
    steps = tr.spans_named("bench.step")
    if not steps:
        return None
    return (sum(e.dur for e in steps) - tr.sync_us_within(steps)) / len(steps) / 1e3
