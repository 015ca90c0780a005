"""Mean ms, over the traced requests, from the start of the program's
``ocpg.engine.run`` span that holds a request to the start of its
``ocpg.engine.dispatch`` span: the time a request waits behind the
groups that the same ``run()`` dispatched before it."""

from benchmark.metrics import program_spans


def read(ctx):
    tr = program_spans.traced(ctx, "infer")
    if tr is None:
        return None
    runs = program_spans.named(tr, "ocpg.engine.run")
    waits = [d.ts - r.ts for d in program_spans.named(tr, "ocpg.engine.dispatch")
             for r in runs if r.tid == d.tid and r.ts <= d.ts and d.end <= r.end]
    return sum(waits) / len(waits) / 1e3 if waits else None
