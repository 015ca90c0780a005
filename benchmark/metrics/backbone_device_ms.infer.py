"""Device ms per eval forward of what the program launches inside its
``ocpg.backbone`` span (the visual backbone, its level masks and positions)."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.device_ms_per_forward(ctx, ["ocpg.backbone"])
