"""Runnable examples of the port (``python -m fenix_tpu_torch.examples.<name>``)."""
