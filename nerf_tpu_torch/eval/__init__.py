"""Image metrics; counterpart of ``nerf_tpu/eval``."""
