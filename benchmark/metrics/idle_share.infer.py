"""The device's idle share of the traced span: 1 less the union of its
kernels', copies' and sets' intervals over the span's wall time, in percent."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx, "infer")
