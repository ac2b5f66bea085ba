"""Command-line entry points (``python -m geomapnet_tpu_torch.cli.eval``)."""
