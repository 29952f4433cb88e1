"""Command line of the port (``python -m polyaxon_tpu_torch.cli``)."""
