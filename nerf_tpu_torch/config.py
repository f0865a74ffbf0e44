"""Config: the ``nerf_tpu`` YAML surface, read without ``nerf_tpu``.

A config is a tree of dicts with attribute access, loaded from YAML with
its ``parent_cfg`` chain merged (parent first), then overridden by trailing
``key.sub value`` pairs. The defaults are ``nerf_tpu``'s for what the port
reads: ``RenderOptions.from_cfg``, the trainer (datasets, optimizer,
schedule, cadence, ``seed``, ``resume``), evaluation (video, background)
and the output directories, which default, as in ``nerf_tpu``, to
``<workspace>/<kind>/<task>/<scene>/<exp_name>`` for ``trained_model_dir``,
``record_dir`` and ``result_dir``.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

import yaml


class Config(dict):
    """dict with attribute access, recursive over nested dicts."""

    def __init__(self, d: Optional[Dict[str, Any]] = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):  # cfg.a.b = v sets the key, as nerf_tpu's Config
        self[name] = value

    def __setitem__(self, name, value):
        super().__setitem__(name, Config(value) if isinstance(value, dict)
                            and not isinstance(value, Config) else value)

    def merge(self, other: Dict[str, Any]) -> "Config":
        """Recursively merge ``other`` into self (other wins)."""
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, dict):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def clone(self) -> "Config":
        return copy.deepcopy(self)

    def set_path(self, dotted: str, value):
        node = self
        parts = dotted.split(".")
        for part in parts[:-1]:
            if not isinstance(node.get(part), Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value


def default_cfg() -> Config:
    return Config({
        "task": "nerf", "exp_name": "default", "scene": "lego",
        "resume": True, "seed": 0, "fix_random": False,
        "train_dataset_module": "blender", "test_dataset_module": "blender",
        "network_module": "nerf",
        "task_arg": {"N_rays": 1024, "white_bkgd": 1, "N_samples": 64, "N_importance": 128,
                     "use_viewdirs": True, "lindisp": False, "perturb": 1.0,
                     "raw_noise_std": 0.0, "precrop_iters": 0, "precrop_frac": 0.5},
        "network": {"nerf": {"W": 256, "D": 8, "skips": [4]},
                    "xyz_encoder": {"type": "frequency", "input_dim": 3, "freq": 10},
                    "dir_encoder": {"type": "frequency", "input_dim": 3, "freq": 4},
                    "dtype": "bfloat16"},
        "train_dataset": {"data_root": "data/nerf_synthetic", "split": "train", "H": 800,
                          "W": 800},
        "test_dataset": {"data_root": "data/nerf_synthetic", "split": "test", "H": 800,
                         "W": 800},
        "train": {"lr": 5e-4, "weight_decay": 0.0, "epoch": 600, "optim": "adam",
                  "scheduler": {"type": "exponential", "gamma": 0.1, "decay_epochs": 500}},
        "ep_iter": 500, "save_ep": 40, "eval_ep": 40, "save_latest_ep": 10,
        "log_interval": 10, "grid_rebuild_ep": 10, "auto_restart": 0,
        "detect_anomaly": False,
        "near": 2.0, "far": 6.0,
        "enable_ess": True, "enable_ert": True, "ert_threshold": 0.01,
        "occupancy_grid_resolution": 128,
        "use_pallas_kernels": True, "use_pallas_integrate": True,
        "render_tile_rays": 8192, "ess_compaction": 0.0,
        "write_video": False, "render_type": "spiral", "render_num": 120, "fps": 24,
        "background_strategy": "none",
        "workspace": "workspace", "trained_model_dir": "", "record_dir": "", "result_dir": "",
    })


def load_cfg(cfg_file: str) -> Config:
    """A YAML file with its ``parent_cfg`` chain merged, parent first."""
    with open(cfg_file) as f:
        current = yaml.safe_load(f) or {}
    parent_path = current.pop("parent_cfg", None)
    if parent_path is None:
        return Config(current)
    if not os.path.isabs(parent_path):
        cand = os.path.join(os.path.dirname(cfg_file), parent_path)
        if os.path.exists(cand):
            parent_path = cand
    return load_cfg(parent_path).merge(current)


def _coerce(value: str):
    """A CLI override string as int, float, or what YAML makes of it."""
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def make_cfg(cfg_file: Optional[str] = None, opts: Optional[List[str]] = None) -> Config:
    """defaults <- YAML chain <- ``key value`` override pairs."""
    cfg = default_cfg()
    if cfg_file:
        cfg.merge(load_cfg(cfg_file))
    opts = list(opts or [])
    if len(opts) % 2:
        raise ValueError(f"overrides must be key/value pairs, got {opts}")
    for key, val in zip(opts[::2], opts[1::2]):
        cfg.set_path(key, _coerce(val))
    tail = os.path.join(cfg.task, cfg.get("scene", ""), cfg.exp_name)
    for key, kind in (("trained_model_dir", "trained_model"), ("record_dir", "record"),
                      ("result_dir", "result")):
        if not cfg.get(key):
            cfg[key] = os.path.join(cfg.get("workspace", "workspace"), kind, tail)
    return cfg
