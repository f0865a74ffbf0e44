"""nerf_tpu_torch: the PyTorch + CUDA port of ``nerf_tpu`` for NVIDIA Hopper.

Mirrors the layout of ``nerf_tpu`` (``models/``, ``render/``, ``ops/``,
``train/``, ``data/``, ``eval/``, ``serve.py``) so that each module's
counterpart is found by name. Imports ``torch`` only: nothing of JAX or of ``nerf_tpu``.
"""
