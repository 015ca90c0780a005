"""The share of the engine's dispatches that reused the previous group's
backbone results, in percent: 100 x ``backbone_reused`` / (``backbone_runs``
+ ``backbone_reused``), the counters of ``ocpg_tpu_torch/engine/infer.py``
over every dispatch of this process (a program without them reads None)."""


def read(ctx):
    if ctx.get("kind") != "infer":
        return None
    from ocpg_tpu_torch.engine import infer

    runs = getattr(infer, "backbone_runs", None)
    reused = getattr(infer, "backbone_reused", None)
    if runs is None or reused is None or not runs + reused:
        return None
    return 100.0 * reused / (runs + reused)
