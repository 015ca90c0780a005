"""Seconds of ``build_model``'s construction and random init in this
process: the program's kept ``ocpg.init`` span
(``ocpg_tpu_torch/utils/profiling.py``), part of ``setup_s``."""


def read(ctx):
    from ocpg_tpu_torch.utils import profiling

    kept_seconds = getattr(profiling, "kept_seconds", None)
    return kept_seconds("ocpg.init") if kept_seconds is not None else None
