"""Command-line entry points of the port (``python -m ocpg_tpu_torch.cli.train``)."""
