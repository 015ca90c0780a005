"""Host ms per train step inside the program's ``ocpg.loss`` span
(``compute_criterion``), less the time blocked in CUDA synchronisation
inside it."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.host_ms_per_step(ctx, ["ocpg.loss"])
