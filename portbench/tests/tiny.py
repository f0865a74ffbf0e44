"""Cells of the benchmark shrunk to run on the CPU in seconds (tests only):
tiny views, frames and grids, few samples; the widths are the cells' own."""
import copy
import time

import torch

from portbench import bench, harness


def shrink(cell: bench.Cell, dtype: str = None, limits: dict = None) -> bench.Cell:
    cell = copy.deepcopy(cell)
    cfg = cell.config["cfg"]
    cfg.update({"occupancy_grid_resolution": 8, "task_arg.N_samples": 8,
                "task_arg.N_importance": 16})
    if dtype:
        cfg["network.dtype"] = dtype
    if cell.kind == "train":
        cell.traffic.update(rays_per_step=32, views=3, view_size=[16, 16], trace_steps=2)
        cfg["scan_chunk"] = 2
        if cfg["network.xyz_encoder.type"] == "hashgrid":
            cfg["network.xyz_encoder.log2_hashmap_size"] = 12
    elif cell.kind == "render":
        cell.traffic.update(frame_size=[16, 16], cameras=3, check_frames=2, check_tile_pixels=32)
        cfg["render_tile_rays"] = 100
    else:
        cell.traffic.update(size=16, rate=8.0, check_requests=2)
        cfg["render_tile_rays"] = 100
    if limits is not None:
        cell.limits = dict(limits)
    return cell


def hashgrid(cell: bench.Cell) -> bench.Cell:
    """A train cell turned into the port's corner hash-grid NeRF
    (``configs/nerf/lego_hashgrid.yaml``) with weights and ESS grid made from
    the seed: the drivers' and the reference's hash-grid path, which no cell
    of the benchmark runs yet."""
    cell = copy.deepcopy(cell)
    cfg = cell.config
    del cfg["checkpoint"]
    cfg.update(name="hashgrid_test", port_cfg="configs/nerf/lego_hashgrid.yaml", grid="seed")
    cfg["cfg"].update({"network.nerf.D": 4, "network.nerf.W": 128, "network.nerf.skips": [],
                       "network.xyz_encoder.type": "hashgrid",
                       "network.xyz_encoder.n_levels": 16, "network.xyz_encoder.n_features": 2,
                       "network.xyz_encoder.log2_hashmap_size": 19,
                       "network.xyz_encoder.base_resolution": 16,
                       "network.xyz_encoder.per_level_scale": 1.3819,
                       "network.xyz_encoder.dtype": "bfloat16",
                       "network.xyz_encoder.layout": "corner",
                       "network.sigma_activation": "softplus", "scan_chunk": 8,
                       "train.lr": 0.001, "train.scheduler.decay_epochs": 100})
    return cell


def context(cell: bench.Cell, seed: int = 2**31 + 7, seconds: float = 0.5) -> harness.Context:
    torch.set_num_threads(1)  # test workers share the machine's cores
    return harness.Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                           device=torch.device("cpu"), t0=time.perf_counter())


def run(cell: bench.Cell, **kw):
    ctx = context(cell, **kw)
    out = bench.driver(cell.kind).run(ctx)
    return harness.result(ctx, out, "cpu"), out
