"""Plain references: the NeRF of ``nerf.py`` and the PNG reader of ``png.py``.

Nothing here imports the program (``nerf_tpu_torch``) or JAX."""
