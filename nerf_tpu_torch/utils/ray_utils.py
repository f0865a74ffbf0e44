"""Ray/box intersection and small base utilities; counterpart of
``nerf_tpu/utils/ray_utils.py``.

``get_near_far`` takes and returns tensors on the caller's device, in the
rays' floating dtype; the rest is host python, as in ``nerf_tpu``.
"""
from __future__ import annotations

import importlib
import os
import pickle
import time
from contextlib import contextmanager

import torch


def get_near_far(rays_o, rays_d, bbox_min, bbox_max, min_near: float = 0.05):
    """Slab-method ray/AABB intersection, ``nerf_tpu``'s arithmetic: a
    direction component below 1e-10 in size taken as +-1e-10 (its sign, + for
    0), hit = (tmax >= tmin) & (tmax > 0), near = max(tmin, min_near), far =
    max(tmax, near + 1e-6), and near = far = 0 on a miss.

    rays_o, rays_d: [N, 3]. Returns (near [N], far [N], hit [N] bool) on
    rays_o's device."""
    rays_o = torch.as_tensor(rays_o)
    if not rays_o.is_floating_point():
        rays_o = rays_o.float()
    rays_d = torch.as_tensor(rays_d, device=rays_o.device, dtype=rays_o.dtype)
    lo = torch.as_tensor(bbox_min, device=rays_o.device, dtype=rays_o.dtype)
    hi = torch.as_tensor(bbox_max, device=rays_o.device, dtype=rays_o.dtype)
    tiny = torch.where(rays_d < 0, -1e-10, 1e-10).to(rays_d.dtype)
    inv = 1.0 / torch.where(rays_d.abs() < 1e-10, tiny, rays_d)
    t0 = (lo - rays_o) * inv
    t1 = (hi - rays_o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    zero = torch.zeros_like(tmin)
    near = torch.where(hit, tmin.clamp_min(min_near), zero)
    far = torch.where(hit, torch.maximum(tmax, near + 1e-6), zero)
    return near, far, hit


@contextmanager
def perf_timer(name: str = "block", log=print):
    """Wall-clock context timer."""
    t0 = time.time()
    yield
    log(f"{name}: {time.time() - t0:.4f}s")


def read_pickle(pkl_path):
    """Unpickle a file."""
    with open(pkl_path, "rb") as f:
        return pickle.load(f)


def save_pickle(data, pkl_path):
    """Pickle to a file, creating parent dirs."""
    parent = os.path.dirname(pkl_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(pkl_path, "wb") as f:
        pickle.dump(data, f)


def load_object(qualified_name: str, module_args: dict | None = None, **extra_args):
    """Instantiate ``pkg.mod.ClassName`` with kwargs: the escape hatch for
    user-provided classes named in configs."""
    module_name, obj_name = qualified_name.rsplit(".", 1)
    obj = getattr(importlib.import_module(module_name), obj_name)
    return obj(**{**(module_args or {}), **extra_args})
