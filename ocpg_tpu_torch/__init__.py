"""PyTorch + CUDA port of ocpg_tpu for NVIDIA Hopper (H100).

The OCPG model's serving path with the ResNet and Swin backbones
(``models.build.build_model``, ``engine.infer.ClipInferenceEngine``), its
train step (``engine.optim.build_optimizer``, ``engine.train.make_train_step``)
with checkpoints (``engine.checkpoint``), the data path and train CLI
(``data.datasets``, ``data.loader.ClipLoader``,
``python -m ocpg_tpu_torch.cli.train``), and the eval engines, metrics and
the evaluate, eval_davis, pretrain, infer_davis and infer_ytvos CLIs
(``engine.evaluate``, ``evaluation``, ``cli``).  The JAX package
``ocpg_tpu`` is the reference; this package imports nothing from it.
"""
