"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Entry points run on ``cuda`` unless the caller asks for the CPU.

    Raises when CUDA is asked for (or implied by ``None``) and no GPU is
    present: the port never carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nerf_tpu_torch: no CUDA device found; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev
