"""Host ms per train step inside the program's ``ocpg.backward`` span: the
main thread's wait while autograd's device thread enqueues the backward,
less the time blocked in CUDA synchronisation inside it."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.host_ms_per_step(ctx, ["ocpg.backward"])
