"""The whole train step's share of the card's bf16 peak over the window: the
FLOPs the frozen reference needs for one step at the batch's shapes
(``FlopCounterMode``'s products plus the frozen MSDA counts, forward and
backward) times the steps completed, over the window's seconds and the peak,
in percent.  It reads the same work whatever implements it."""

from benchmark import counts


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("flops_per_step"):
        return None
    return 100.0 * ctx["flops_per_step"] * ctx["steps"] / ctx["window_s"] / counts.PEAK_FLOPS
