"""Command-line tools of the port (``python -m pcgan_tpu_torch.tools.<name>``)."""
