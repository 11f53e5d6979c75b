"""Command-line entry points of the port (``python -m volrend_torch.cli.headless``)."""
