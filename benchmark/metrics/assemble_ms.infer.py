"""Host ms per traced request inside the program's ``ocpg.engine.assemble``
(the numpy canvas, mask, ids and sizes) and ``ocpg.engine.upload`` (the
pinned uploads and the frames' normalisation) spans."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.host_ms_per_request(ctx, ["ocpg.engine.assemble",
                                                   "ocpg.engine.upload"])
