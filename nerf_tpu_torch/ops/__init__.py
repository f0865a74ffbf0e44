"""See the package docstring of nerf_tpu_torch."""
