"""What the harness takes from the program (``nerf_tpu_torch``): its config,
its kernels' build, its parameter trees by leaf path.

A configuration file names the port's YAML (``port_cfg``) and gives every
key the benchmark depends on under ``cfg``; those values are set over the
YAML's, so an edit of the YAML does not move the benchmark.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import bench, harness


def port_cfg(cell: bench.Cell, **extra):
    """The port's config of the cell: its YAML, then every ``cfg`` key of the
    configuration file, then ``extra`` (paths inside the checkout)."""
    from nerf_tpu_torch.config import make_cfg

    cfg = make_cfg(str(cell.root / cell.config["port_cfg"]))
    for key, value in {**cell.config["cfg"], **extra}.items():
        cfg.set_path(key, value)
    return cfg


def build_kernels(cell: bench.Cell, device) -> None:
    """Build (or find built) only the CUDA sources the cell runs: those the
    configuration lists for the cell's driver."""
    if device.type != "cuda":
        return
    from nerf_tpu_torch.ops import build

    built = build.build(cell.config["kernels"][cell.kind])
    if built:
        harness.log("built " + ", ".join(f"{k} ({v:.1f} s)" for k, v in built.items()))


def leaf_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, object]]:
    """(path, leaf) of a nested dict/list tree, dict keys sorted, lists in
    order: the order of the program's ``tree_leaves`` and of its optimizer
    state."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaf_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def checkpoint_path(cell: bench.Cell) -> str:
    return str(cell.root / cell.config["checkpoint"])


def kernel_counters() -> Dict[str, int]:
    """The port's launch counters of the kernels a cell may run."""
    from nerf_tpu_torch.ops import fused_mlp, fused_mlp_bwd, hash_gather, integrate

    return {"fused_nerf_eval": fused_mlp.fused_nerf_eval.launches,
            "fused_nerf_bwd": getattr(fused_mlp_bwd.fused_nerf_bwd, "launches", 0),
            "gather_rows": hash_gather.gather_rows.launches,
            "scatter_add_rows": hash_gather.scatter_add_rows.launches,
            "integrate": integrate.integrate.launches}
