"""The padding's share of the pixels the engine dispatched, in percent:
100 x (1 - ``pixels_real`` / ``pixels_dispatched``), the counters of
``ocpg_tpu_torch/engine/infer.py`` over every dispatch of this process
(frames x rows x columns of the requests, and slots x clip length x the
canvas of their dispatches)."""


def read(ctx):
    if ctx.get("kind") != "infer":
        return None
    from ocpg_tpu_torch.engine import infer

    real = getattr(infer, "pixels_real", None)
    dispatched = getattr(infer, "pixels_dispatched", None)
    if real is None or not dispatched:
        return None
    return 100.0 * (1.0 - real / dispatched)
