"""PyTorch + CUDA port of ocpg_tpu for NVIDIA Hopper (H100).

The OCPG model's serving path with the ResNet and Swin backbones
(``models.build.build_model``, ``engine.infer.ClipInferenceEngine``) and its
train step with the ResNet backbones (``engine.optim.build_optimizer``,
``engine.train.make_train_step``).  The JAX package ``ocpg_tpu`` is the
reference; this package imports nothing from it.
"""
