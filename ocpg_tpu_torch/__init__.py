"""PyTorch + CUDA port of ocpg_tpu for NVIDIA Hopper (H100).

The serving path of the OCPG model: ``models.build.build_model`` and
``engine.infer.ClipInferenceEngine``.  The JAX package ``ocpg_tpu`` is the
reference; this package imports nothing from it.
"""
