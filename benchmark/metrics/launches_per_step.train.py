"""Device kernels per train step: the kernels whose correlation id is that
of a runtime call, on any thread (autograd's too), that starts inside one
of the program's ``ocpg.step`` spans.  A replayed CUDA graph's kernels
carry the graph launch's id, so they count too."""

from benchmark.metrics import program_spans


def read(ctx):
    tr = program_spans.traced(ctx, "train")
    if tr is None:
        return None
    steps = program_spans.named(tr, "ocpg.step")
    if not steps or not tr.kernels:
        return None
    corrs = {e.corr for e in tr.runtime
             if e.corr is not None and any(s.ts <= e.ts <= s.end for s in steps)}
    return sum(k.corr in corrs for k in tr.kernels) / len(steps)
