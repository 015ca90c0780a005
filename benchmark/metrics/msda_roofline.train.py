"""The MSDA kernels' share of their roofline in the traced span: the sum over
the calls of each call's least time (the larger of its FLOPs over the bf16
peak and its bytes over the HBM rate, from its shapes by the frozen counts
of ``benchmark/counts.py``; a backward too where the call took a gradient)
over the device time of the forward and backward kernels, in percent."""

from benchmark import readers


def read(ctx):
    return readers.msda_roofline(ctx, "train")
