"""Evaluation (metrics, the evaluator, background conversion, video);
counterpart of ``nerf_tpu/eval``."""
