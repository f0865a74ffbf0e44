"""Weight bridge from ``nerf_tpu`` checkpoints; counterpart of ``nerf_tpu/train/checkpoint.py``.

A ``nerf_tpu`` checkpoint is one ``.npz`` of the flattened TrainState
pytree, ``leaf_0 ... leaf_<n>``, in JAX's flatten order: dict keys sorted,
lists in order, params first. For the hierarchical NeRF the params are
{"coarse": mlp, "fine": mlp}, so leaves 0-23 are the coarse MLP and 24-47
the fine one; what follows is optimizer state and is skipped. Within one
MLP the order is alpha_linear{b, w}, feature_linear{b, w},
pts_linears[0..D-1]{b, w}, rgb_linear{b, w}, views_linears[0]{b, w}.

Reading needs no JAX: the leaf order is rebuilt here from the model's shape.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

from ..models.nerf_mlp import NeRFMLP

Tree = Dict[str, Any]


def _mlp_leaf_shapes(D: int = 8, W: int = 256, input_ch: int = 63,
                     input_ch_views: int = 27, skips=(4,)) -> List[Tuple[tuple, tuple]]:
    """[(path, shape)] of one MLP in JAX flatten order."""
    out = [(("alpha_linear", "b"), (1,)), (("alpha_linear", "w"), (W, 1)),
           (("feature_linear", "b"), (W,)), (("feature_linear", "w"), (W, W))]
    in_dim = input_ch
    for i in range(D):
        out += [(("pts_linears", i, "b"), (W,)), (("pts_linears", i, "w"), (in_dim, W))]
        in_dim = W + input_ch if i in skips else W
    out += [(("rgb_linear", "b"), (3,)), (("rgb_linear", "w"), (W // 2, 3)),
            (("views_linears", 0, "b"), (W // 2,)),
            (("views_linears", 0, "w"), (W + input_ch_views, W // 2))]
    return out


def _set(tree: Tree, path: tuple, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def load_params(model_dir: str, tag: str = "latest", **mlp_shape) -> Tree:
    """Read the {"coarse", "fine"} params of a ``nerf_tpu`` NeRF checkpoint as
    a JAX-layout pytree of float32 numpy arrays (weights [in, out]).

    Raises ``FileNotFoundError`` when the checkpoint is missing and
    ``ValueError`` when a leaf does not have the expected shape.
    """
    path = os.path.join(model_dir, f"{tag}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    leaves = _mlp_leaf_shapes(**mlp_shape)
    params: Tree = {}
    with np.load(path) as data:
        for m, model in enumerate(("coarse", "fine")):
            for j, (sub, shape) in enumerate(leaves):
                i = m * len(leaves) + j
                arr = data[f"leaf_{i}"]
                if arr.shape != shape:
                    raise ValueError(f"{path}: leaf_{i} ({model}.{sub}) has shape "
                                     f"{arr.shape}, expected {shape}")
                _set(params, (model,) + sub, np.asarray(arr, np.float32))
    return params


def from_jax_params(tree: Tree, skips=(4,)) -> Dict[str, NeRFMLP]:
    """{"coarse": mlp_tree, "fine": mlp_tree} of numpy arrays -> {name: NeRFMLP}."""
    return {name: NeRFMLP.from_tree(sub, skips=skips) for name, sub in tree.items()}
