"""Datasets; counterpart of ``nerf_tpu/data``."""
from __future__ import annotations


def make_dataset(cfg, split: str):
    """The dataset of ``cfg.<split>_dataset_module`` ("train" or "test"), as
    ``nerf_tpu.data.blender.make_dataset`` dispatches it: "blender" (a scene
    on disk) or "synthetic" (in memory)."""
    module = str(cfg.get(f"{split}_dataset_module", "blender"))
    if module == "synthetic":
        from .synthetic import make_synthetic_dataset

        return make_synthetic_dataset(cfg, split)
    if module == "blender":
        from .blender import make_blender_dataset

        return make_blender_dataset(cfg, split)
    raise ValueError(f"unknown dataset module {module!r}")
