"""Host ms per train step inside the program's ``ocpg.optim.clip`` and
``ocpg.optim.step`` spans (the global-norm clip and AdamW), less the time
blocked in CUDA synchronisation inside them."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.host_ms_per_step(ctx, ["ocpg.optim.clip", "ocpg.optim.step"])
