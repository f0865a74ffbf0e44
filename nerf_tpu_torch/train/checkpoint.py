"""Checkpoint I/O in ``nerf_tpu``'s format; counterpart of ``nerf_tpu/train/checkpoint.py``.

A ``nerf_tpu`` checkpoint is one ``.npz`` of the flattened TrainState
pytree, ``leaf_0 ... leaf_<n>``, in JAX's flatten order: dict keys sorted,
lists in order, params first, plus ``<tag>.json`` with the epoch and the
recorder's state. For the hierarchical NeRF the params are {"coarse": mlp,
"fine": mlp}, so leaves 0-23 are the coarse MLP and 24-47 the fine one.
Within one MLP the order is alpha_linear{b, w}, feature_linear{b, w},
pts_linears[0..D-1]{b, w}, rgb_linear{b, w}, views_linears[0]{b, w}. With
Adam (or RAdam) the optimizer state follows: its count (48), mu (49-96), nu
(97-144) and the schedule's count (145); then the step (146). With SGD only
the schedule's count sits between the params and the step.

A hash-grid model adds its table, ``xyz_encoder.table``, after
views_linears: leaf 16 of the coarse model and 33 of the fine one, 105
leaves in all with Adam. A bfloat16 leaf (the table, and Adam's moments of
it) is stored as numpy writes JAX's bfloat16, as raw two-byte voids
(``|V2``); the port reads those bits through uint16 and writes them back the
same way.

A distilled KiloNeRF (``<trained_model_dir>/kilonerf``) holds 32 leaves:
l1..l5 {b [G, out], w [G, in, out]} (10), then ``optax.adam``'s count, mu
(10) and nu (10), which keeps no schedule counter, then the step
(``kilonerf_template``, ``load_kilonerf``).

Reading and writing need no JAX: the leaf order is rebuilt here from the
model's shape, and the files load in ``nerf_tpu.train.checkpoint`` as its
own do.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.nerf_mlp import NeRFMLP
from ..tree import tree_flatten, tree_unflatten

Tree = Dict[str, Any]


def _mlp_leaf_shapes(D: int = 8, W: int = 256, input_ch: int = 63,
                     input_ch_views: int = 27, skips=(4,),
                     hash_table: Optional[tuple] = None,
                     use_viewdirs: bool = True) -> List[Tuple[tuple, tuple]]:
    """[(path, shape)] of one MLP (and its hash table) in JAX flatten order.
    Without view directions the heads are output_linear [W, 4], which sorts
    before pts_linears."""
    out = ([(("alpha_linear", "b"), (1,)), (("alpha_linear", "w"), (W, 1)),
            (("feature_linear", "b"), (W,)), (("feature_linear", "w"), (W, W))]
           if use_viewdirs else
           [(("output_linear", "b"), (4,)), (("output_linear", "w"), (W, 4))])
    in_dim = input_ch
    for i in range(D):
        out += [(("pts_linears", i, "b"), (W,)), (("pts_linears", i, "w"), (in_dim, W))]
        in_dim = W + input_ch if i in skips else W
    if use_viewdirs:
        out += [(("rgb_linear", "b"), (3,)), (("rgb_linear", "w"), (W // 2, 3)),
                (("views_linears", 0, "b"), (W // 2,)),
                (("views_linears", 0, "w"), (W + input_ch_views, W // 2))]
    if hash_table is not None:
        out.append((("xyz_encoder", "table"), tuple(hash_table)))
    return out


def _bf16_bits(arr: np.ndarray) -> bool:
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def bf16_to_float32(arr: np.ndarray) -> np.ndarray:
    """Raw bfloat16 bits (``|V2`` or uint16) -> float32, exactly."""
    return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def bf16_tensor(arr: np.ndarray) -> torch.Tensor:
    """Raw bfloat16 bits -> a torch.bfloat16 tensor holding them."""
    return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)


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


def load_params(model_dir: str, tag: str = "latest", ngp=None, **mlp_shape) -> Tree:
    """Read the {"coarse", "fine"} params of a ``nerf_tpu`` NeRF checkpoint as
    a JAX-layout pytree of float32 numpy arrays (weights [in, out]). A
    hash-grid model (``hash_table=`` its table's shape) gets its table too,
    its bfloat16 values widened to float32 exactly; a model without view
    directions (``use_viewdirs=False``) has output_linear for its heads.
    Instant-NGP's network (``ngp=`` its [(path, shape)], the first leaves
    of the port's file) is read as {"coarse": net}.

    Raises ``FileNotFoundError`` when the checkpoint is missing and
    ``ValueError`` when a leaf does not have the expected shape.
    """
    path = os.path.join(model_dir, f"{tag}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    leaves = ngp if ngp is not None else _mlp_leaf_shapes(**mlp_shape)
    params: Tree = {}
    with np.load(path) as data:
        for m, model in enumerate(("coarse",) if ngp is not None else ("coarse", "fine")):
            for j, (sub, shape) in enumerate(leaves):
                i = m * len(leaves) + j
                arr = data[f"leaf_{i}"]
                if arr.shape != shape:
                    raise ValueError(f"{path}: leaf_{i} ({model}.{sub}) has shape "
                                     f"{arr.shape}, expected {shape}")
                value = bf16_to_float32(arr) if _bf16_bits(arr) else arr
                # C order, as a fresh model's leaves are: a JAX file may hold a
                # leaf in Fortran order (the optimizer's kernel takes C order)
                _set(params, (model,) + sub, np.ascontiguousarray(value, np.float32))
    return params


def from_jax_params(tree: Tree, skips=(4,)) -> Dict[str, NeRFMLP]:
    """{"coarse": mlp_tree, "fine": mlp_tree} of numpy arrays -> {name: NeRFMLP}."""
    return {name: NeRFMLP.from_tree(sub, skips=skips) for name, sub in tree.items()}


def from_jax_kilonerf(tree: Tree, device: Optional[torch.device] = None,
                      requires_grad: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """A KiloNeRF model of the JAX package ({"l1".."l5": {"w": [G, in, out],
    "b": [G, out]}}, numpy or JAX arrays) -> the port's float32 tensors."""
    return {name: {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                   .requires_grad_(requires_grad) for k, v in layer.items()}
            for name, layer in tree.items()}


KILONERF_DIR = "kilonerf"  # under trained_model_dir, where the distillation saves


def kilonerf_template(cfg_kilo, lr: float = 1e-3, device=None):
    """The TrainState the distillation saves, shaped for ``cfg_kilo`` (a
    ``KiloConfig``): params l1..l5, ``plain_adam``'s (count, mu, nu), step;
    32 leaves, the layout of the JAX package's ``TrainState(params,
    optax.adam(lr).init(params), step)``."""
    from ..ops.kilonerf import layer_shapes, n_networks
    from .optim import plain_adam
    from .state import init_state

    G = n_networks(cfg_kilo)
    params = {name: {"w": torch.zeros(G, fi, fo, device=device).requires_grad_(True),
                     "b": torch.zeros(G, fo, device=device).requires_grad_(True)}
              for name, (fi, fo) in layer_shapes(cfg_kilo).items()}
    return init_state(params, plain_adam(lr))


def load_kilonerf(model_dir: str, cfg_kilo, device=None):
    """The distilled KiloNeRF params in ``<model_dir>/kilonerf`` (the JAX
    package's file or the port's), as float32 tensors on ``device``.
    Raises ``FileNotFoundError`` when there is no checkpoint."""
    path = os.path.join(model_dir, KILONERF_DIR)
    ckpt = load_checkpoint(path, kilonerf_template(cfg_kilo, device=device))
    if ckpt is None:
        raise FileNotFoundError(f"no kilonerf checkpoint in {path}")
    return {k: {n: t.detach() for n, t in v.items()} for k, v in ckpt[0].params.items()}


def _state_leaves(state) -> list:
    """A TrainState's leaves in JAX's order: params, optimizer state, step."""
    return tree_flatten(state.params)[0] + state.opt_state.leaves() + [state.step]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:  # JAX's bfloat16 as np.savez stores it
            return leaf.detach().cpu().view(torch.int16).numpy().view(np.dtype("V2"))
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.int32)  # the counters: int32 scalars, as JAX keeps them


def save_checkpoint(model_dir: str, state, epoch: int, recorder_state: Optional[Dict] = None,
                    latest: bool = True, keep: int = 5) -> None:
    """Write ``<epoch>.npz/.json`` (and ``latest`` unless told not to), then
    keep only the newest ``keep`` numbered checkpoints."""
    os.makedirs(model_dir, exist_ok=True)
    arrays = {f"leaf_{i}": _to_numpy(v) for i, v in enumerate(_state_leaves(state))}
    meta = {"epoch": epoch, "recorder": recorder_state or {}}
    for tag in [str(epoch)] + (["latest"] if latest else []):
        np.savez(os.path.join(model_dir, f"{tag}.npz"), **arrays)
        with open(os.path.join(model_dir, f"{tag}.json"), "w") as f:
            json.dump(meta, f)
    epochs = sorted(int(f[:-4]) for f in os.listdir(model_dir)
                    if f.endswith(".npz") and f[:-4].isdigit())
    for old in epochs[:-keep]:
        for ext in (".npz", ".json"):
            path = os.path.join(model_dir, f"{old}{ext}")
            if os.path.exists(path):
                os.remove(path)


def load_checkpoint(model_dir: str, template, tag: str = "latest"):
    """Restore a TrainState shaped as ``template`` (its params' tree and
    devices, its optimizer's kind). Returns (state, epoch, recorder_state),
    or None when there is no checkpoint. Raises ``ValueError`` when the file
    has another number of leaves or a leaf another shape."""
    path = os.path.join(model_dir, f"{tag}.npz")
    if not os.path.exists(path):
        return None
    want = _state_leaves(template)
    with np.load(path) as data:
        if len(data.files) != len(want):
            raise ValueError(f"{path}: {len(data.files)} leaves, expected {len(want)}")
        arrays = [data[f"leaf_{i}"] for i in range(len(want))]
    leaves = []
    for i, (arr, like) in enumerate(zip(arrays, want)):
        if isinstance(like, torch.Tensor):
            if arr.shape != tuple(like.shape):
                raise ValueError(f"{path}: leaf_{i} has shape {arr.shape}, expected "
                                 f"{tuple(like.shape)}")
            if like.dtype == torch.bfloat16:
                if not _bf16_bits(arr):
                    raise ValueError(f"{path}: leaf_{i} is {arr.dtype}, expected bfloat16 bits")
                leaves.append(bf16_tensor(arr).to(like.device))
            else:
                # C order, as in ``load_params``: the optimizer's kernel
                # updates contiguous tensors in place
                arr = np.ascontiguousarray(arr, np.float32)
                leaves.append(torch.from_numpy(arr).to(like.device))
        else:
            if arr.shape != ():
                raise ValueError(f"{path}: leaf_{i} has shape {arr.shape}, expected a counter")
            leaves.append(int(arr))
    n_params = len(tree_flatten(template.params)[0])
    params_spec = tree_flatten(template.params)[1]
    params = tree_unflatten(params_spec, [t.requires_grad_(True) for t in leaves[:n_params]])
    opt = template.opt_state
    rest = leaves[n_params:-1]
    sched = None if opt.sched_count is None else rest[-1]
    if opt.mu is None:
        opt_state = dataclasses.replace(opt, sched_count=sched)
    else:
        n = len(opt.mu)
        opt_state = dataclasses.replace(opt, count=rest[0], mu=rest[1:1 + n],
                                        nu=rest[1 + n:1 + 2 * n], sched_count=sched)
    state = dataclasses.replace(template, params=params, opt_state=opt_state, step=leaves[-1])
    meta = {"epoch": -1, "recorder": {}}
    meta_path = os.path.join(model_dir, f"{tag}.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, int(meta.get("epoch", -1)), meta.get("recorder", {})


def wipe_dir(path: str) -> None:
    """Remove a directory tree (a run that does not resume)."""
    if os.path.exists(path):
        shutil.rmtree(path)
