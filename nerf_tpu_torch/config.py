"""Config: the ``nerf_tpu`` YAML surface, read without ``nerf_tpu``.

A config is a tree of dicts with attribute access (dicts inside lists and
tuples wrapped too), loaded from YAML with its ``parent_cfg`` chain merged
(parent first), then overridden by trailing ``key.sub value`` pairs. The
defaults are ``nerf_tpu``'s for what the port reads: ``RenderOptions.from_cfg``,
the trainer (datasets, optimizer, schedule, cadence, ``seed``, ``resume``),
evaluation (video, background) and the output directories.

``make_cfg`` ends in ``parse_cfg``, as ``nerf_tpu``'s does: ``bbox`` made a
cube about its centre, ``exp_name_tag`` appended to ``exp_name``, the words
``gitbranch`` and ``gitcommit`` in ``exp_name`` replaced by the checkout's
branch and commit, and only then ``trained_model_dir``, ``record_dir`` and
``result_dir`` derived, where unset, as
``<workspace>/<kind>/<task>/<scene>/<exp_name>``. So a command line names
the same directories in the port as in ``nerf_tpu``.
"""
from __future__ import annotations

import argparse
import copy
import os
import subprocess
from typing import Any, Dict, List, Optional

import numpy as np
import yaml


class Config(dict):
    """dict with attribute access, recursive over nested dicts and over the
    dicts inside lists and tuples."""

    def __init__(self, d: Optional[Dict[str, Any]] = None, **kwargs):
        super().__init__()
        for k, v in {**(d or {}), **kwargs}.items():
            self[k] = v

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):  # cfg.a.b = v sets the key, as nerf_tpu's Config
        self[name] = value

    def __setitem__(self, name, value):
        super().__setitem__(name, self._wrap(value))

    def get_path(self, dotted: str, default=None):
        """The value at ``a.b.c``, or ``default`` where a part is missing."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value):
        node = self
        parts = dotted.split(".")
        for part in parts[:-1]:
            if not isinstance(node.get(part), Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

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

    def to_dict(self) -> Dict[str, Any]:
        """Plain dicts all the way down; a list or tuple of the tree comes
        back as a list, its Config items as dicts."""
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = [x.to_dict() if isinstance(x, Config) else x for x in v]
            else:
                out[k] = v
        return out


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


def _git_describe(args: str) -> str:
    """``git describe <args>`` in the working directory, or "" where git fails."""
    try:
        out = subprocess.run(["git", "describe"] + args.split(),
                             capture_output=True, text=True, timeout=5)
        return out.stdout.strip()
    except Exception:
        return ""


def parse_cfg(cfg: Config) -> Config:
    """``nerf_tpu``'s exp-name rules, in its order, then the directories:
    ``bbox`` (six numbers, min then max) made the cube of its largest side
    about its centre; ``exp_name_tag`` appended as ``<exp_name>_<tag>``;
    ``gitbranch`` replaced by ``git describe --all`` less its first six
    characters ("heads/") or "nobranch"; ``gitcommit`` by ``git describe
    --tags --always`` or "nocommit"; then each unset directory
    ``<workspace>/<kind>/<task>/<scene>/<exp_name>``."""
    if cfg.get("bbox"):
        bbox = np.asarray(cfg.bbox, np.float64).reshape(2, 3)
        center = bbox.mean(axis=0)
        half = float((bbox[1] - bbox[0]).max()) / 2.0
        cfg.bbox = np.stack([center - half, center + half]).reshape(6).tolist()
    if cfg.get("exp_name_tag"):
        cfg.exp_name = f"{cfg.exp_name}_{cfg.exp_name_tag}"
    if "gitbranch" in cfg.exp_name:
        cfg.exp_name = cfg.exp_name.replace(
            "gitbranch", _git_describe("--all")[6:] or "nobranch")
    if "gitcommit" in cfg.exp_name:
        cfg.exp_name = cfg.exp_name.replace(
            "gitcommit", _git_describe("--tags --always") or "nocommit")
    tail = os.path.join(cfg.task, cfg.get("scene", ""), cfg.exp_name)
    for key, kind in (("trained_model_dir", "trained_model"), ("record_dir", "record"),
                      ("result_dir", "result")):
        if not cfg.get(key):
            cfg[key] = os.path.join(cfg.get("workspace", "workspace"), kind, tail)
    return cfg


def make_cfg(cfg_file: Optional[str] = None, opts: Optional[List[str]] = None) -> Config:
    """defaults <- YAML chain <- ``key value`` override pairs, then ``parse_cfg``."""
    cfg = default_cfg()
    if cfg_file:
        cfg.merge(load_cfg(cfg_file))
    opts = list(opts or [])
    if len(opts) % 2:
        raise ValueError(f"overrides must be key/value pairs, got {opts}")
    for key, val in zip(opts[::2], opts[1::2]):
        cfg.set_path(key, _coerce(val))
    return parse_cfg(cfg)


def parse_args(argv: Optional[List[str]] = None):
    """``nerf_tpu``'s command line: ``--cfg_file --test --type --det`` and
    trailing ``key value`` overrides. Returns (cfg, args)."""
    parser = argparse.ArgumentParser(description="nerf_tpu_torch")
    parser.add_argument("--cfg_file", default=None)
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--type", default="")
    parser.add_argument("--det", default="")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    return make_cfg(args.cfg_file, args.opts), args
