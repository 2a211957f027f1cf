"""Runnable examples of the port (``python -m
scenery_insitu_tpu_torch.examples.<name>``)."""
