"""Datasets; counterpart of ``nerf_tpu/data``."""
from __future__ import annotations


def make_dataset(cfg, split: str):
    """The dataset of ``cfg.<split>_dataset_module`` ("train" or "test"), as
    ``nerf_tpu.data.blender.make_dataset`` dispatches it. Only "synthetic" is
    ported: "blender" raises ``NotImplementedError``."""
    module = str(cfg.get(f"{split}_dataset_module", "blender"))
    if module == "synthetic":
        from .synthetic import make_synthetic_dataset

        return make_synthetic_dataset(cfg, split)
    if module == "blender":
        raise NotImplementedError(
            "the Blender dataset is not available to the port: the lego images are not "
            "in the repository and the Blender loader (PNG reading) is not ported; "
            f"set {split}_dataset_module synthetic")
    raise ValueError(f"unknown dataset module {module!r}")
