"""Host ms per train step inside the program's ``ocpg.forward`` span (the
train forward's enqueue, matcher included), less the time blocked in CUDA
synchronisation inside it."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.host_ms_per_step(ctx, ["ocpg.forward"])
