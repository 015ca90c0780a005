"""PyTorch + CUDA port of ocpg_tpu for NVIDIA Hopper (H100).

The OCPG model's serving path (``models.build.build_model``,
``engine.infer.ClipInferenceEngine``) and its train step
(``engine.optim.build_optimizer``, ``engine.train.make_train_step``).  The JAX package ``ocpg_tpu`` is the
reference; this package imports nothing from it.
"""
