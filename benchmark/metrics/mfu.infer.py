"""The serving path's share of the card's bf16 peak over the window: the FLOPs
the frozen reference needs per frame of the engine's padded clip (one eval
forward's ``FlopCounterMode`` products plus the frozen MSDA counts, over its
frames) times the real frames served, over the window's seconds and the
peak, in percent."""

from benchmark import counts


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx.get("flops_per_frame"):
        return None
    return 100.0 * ctx["flops_per_frame"] * ctx["frames"] / ctx["window_s"] / counts.PEAK_FLOPS
