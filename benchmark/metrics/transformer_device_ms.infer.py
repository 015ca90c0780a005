"""Device ms per eval forward of what the program launches inside its
``ocpg.transformer`` span (the deformable encoder and decoder, K1)."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.device_ms_per_forward(ctx, ["ocpg.transformer"])
