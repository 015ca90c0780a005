"""Device ms per eval forward of what the program launches inside its
``ocpg.text`` (the text encoder and its projections) and ``ocpg.fusion``
(the level loop: projections, GroupNorm, the frequency filters, the
vision-language fusion) spans."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.device_ms_per_forward(ctx, ["ocpg.text", "ocpg.fusion"])
