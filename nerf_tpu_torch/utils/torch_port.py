"""Reference PyTorch checkpoints -> the port's param trees; counterpart of
``nerf_tpu/utils/torch_port.py``.

The reference's checkpoint (``src/utils/net_utils.py:288``) is ``{net:
state_dict, optim, scheduler, recorder, epoch}``; its network state_dict
carries the coarse model under ``model.`` and the fine model under
``model_fine.`` (``src/models/nerf/network.py:142-159``), behind a
``module.`` prefix when it was saved from DistributedDataParallel.

The file is read with ``torch.load(weights_only=True)``: tensors, numbers,
strings and containers of them, which is what that format holds; a file
that pickles other objects raises instead of running their code.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.nerf_mlp import load_torch_state_dict


def strip_prefix(state_dict: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries whose key starts with ``prefix``, with it taken off."""
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def read_reference_checkpoint(path: str) -> Dict[str, Any]:
    """The reference ``.pth`` as saved (a dict)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: expected a dict, got {type(ckpt).__name__}")
    return ckpt


def load_reference_checkpoint(path: str, D: int = 8, use_viewdirs: bool = True
                              ) -> Dict[str, Any]:
    """A reference ``.pth`` -> {"coarse": tree, "fine": tree} (JAX layout,
    float32 CPU tensors)."""
    ckpt = read_reference_checkpoint(path)
    sd = ckpt.get("net", ckpt)
    if any(k.startswith("module.") for k in sd):
        sd = strip_prefix(sd, "module.")
    return {"coarse": load_torch_state_dict(strip_prefix(sd, "model."), D, use_viewdirs),
            "fine": load_torch_state_dict(strip_prefix(sd, "model_fine."), D, use_viewdirs)}


def reference_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{"coarse": tree, "fine": tree} (JAX layout, weights [in, out]) -> the
    reference's network state_dict (``model.`` / ``model_fine.``, weights
    [out, in]): what ``load_reference_checkpoint`` reads back."""
    sd = {}
    for prefix, tree in (("model.", params["coarse"]), ("model_fine.", params["fine"])):
        for name, node in tree.items():
            for i, leaf in enumerate(node) if isinstance(node, list) else [(None, node)]:
                key = prefix + name + ("" if i is None else f".{i}")
                w, b = torch.as_tensor(leaf["w"]), torch.as_tensor(leaf["b"])
                sd[key + ".weight"] = w.detach().cpu().float().t().contiguous()
                sd[key + ".bias"] = b.detach().cpu().float().clone()
    return sd
