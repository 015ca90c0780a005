"""The Swin window attention's share of its roofline in the traced span: the
sum over the calls of each call's least time (forward, and in training the
backward, from the shapes by the frozen counts of ``benchmark/counts.py``)
over the device time of the forward kernel (K7) and of the kernels launched
under its autograd backward, in percent.  Nothing to read without a Swin."""

from benchmark import readers


def read(ctx):
    return readers.wattn_roofline(ctx, "infer")
