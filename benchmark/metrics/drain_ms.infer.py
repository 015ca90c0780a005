"""Host ms per traced request inside the program's ``ocpg.engine.drain``
span (the crop and cast of the masks read back, the progress callback),
less its ``ocpg.engine.wait`` (the wait for the readback's event)."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.host_ms_per_request(ctx, ["ocpg.engine.drain"],
                                             less=["ocpg.engine.wait"])
