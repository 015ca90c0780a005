"""Host ms per request inside ``ClipInferenceEngine.run``, less the host ms
of the model's forwards and less the time blocked in CUDA synchronisation
outside them (the profiler's runtime events), in the traced span."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "infer" or tr is None or not ctx.get("traced_requests"):
        return None
    runs, fwd = tr.spans_named("bench.run"), tr.spans_named("bench.forward")
    if not runs:
        return None
    sync = tr.sync_us_within(runs) - tr.sync_us_within(fwd)
    host = sum(e.dur for e in runs) - sum(e.dur for e in fwd) - sync
    return host / ctx["traced_requests"] / 1e3
