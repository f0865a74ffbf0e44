"""Measurement scripts of the port, run on the GPU (``python -m nerf_tpu_torch.tools.<name>``)."""
