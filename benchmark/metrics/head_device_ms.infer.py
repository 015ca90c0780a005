"""Device ms per eval forward of what the program launches inside its
``ocpg.heads`` span (class and box heads, the dynamic-conv mask head, the
query pick, the mask refinement and the final resize)."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.device_ms_per_forward(ctx, ["ocpg.heads"])
