"""The plain float32 reference that decides a run's ``correct``.

A frozen copy of the port's plain modules (``ocpg_tpu_torch/models``,
``ops/image.py``, ``utils/box_ops.py``, ``config.py``), taken when the
benchmark was defined, with the hand-written kernels replaced by their
plain versions (``plain_ops.py``) and nothing of the program imported:
imports here are relative or of ``torch``, ``numpy`` and the standard
library.  ``step.py`` holds the train step and the serving forward built
on it, ``lowp.py`` the float8 control.  Later changes to the program do
not reach this copy, so the program is held to the model as it stood.
Backbones are found by name (``ocpg.backbone_table``): each
``backbone_*.py`` module lists the names it builds in ``BACKBONES``, so a
later backbone comes as a new module and no file here is edited.
"""
