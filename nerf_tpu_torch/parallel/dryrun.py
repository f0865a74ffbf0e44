"""The 1-vs-N checks of data and expert parallelism; counterpart of ``__graft_entry__.dryrun_multichip``.

    python -m nerf_tpu_torch.parallel.dryrun [--devices N] [--device cuda|cpu]

``dryrun_multichip(n)`` makes JAX's two checks with JAX's bounds:
- the real trainer (``python -m nerf_tpu_torch.train``) on JAX's tiny config
  (``tiny_overrides``: 2 synthetic 16x16 images, 2 epochs of 2 steps,
  8 + 8 samples, float32, validation each epoch) at world N against world
  1, the same global batch of 8 N rays: the first layer's trained weights
  within 2e-5;
- ``kilonerf_eval_ep`` over N ranks against the dense ``kilonerf_eval`` (64
  networks of hidden width 16, 64 N points, capacities that suffice):
  within 2e-5 (absolute and relative).
The ranks run on CUDA, one a card over NCCL, unless the caller asks for
the CPU (``--device cpu``), where they are gloo processes (JAX uses
virtual CPU devices).

The module's ``step``, ``ep`` and ``collectives`` commands are the ranks'
side of the tests that hold these paths against the JAX package and the
multihost helpers against their definitions: each rank reads its inputs
from an ``.npz``, runs its share, and rank 0 (``collectives``: each rank)
writes the results.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import make_cfg
from ..device import resolve_device
from ..ops.kilonerf import LAYERS, KiloConfig, init_kilonerf, kilonerf_eval
from ..render.renderer import RenderOptions
from ..tree import tree_leaves
from .mesh import data_group, destroy, init_distributed, launch, shard_batch
from .multihost import gather_to_main, is_main_process

TRAINED_ATOL = 2e-5
EP_TOL = 2e-5


@contextlib.contextmanager
def fed_fine_samples(z_rows: torch.Tensor):
    """Inside the block the renderer's fine samples are ``z_rows`` (this
    rank's rows of another implementation's), whatever the coarse weights:
    two float32 renders can put a sample on either side of a CDF step, and
    that ray's fine points then differ far beyond rounding."""
    from ..render import renderer

    real = renderer.sample_pdf
    renderer.sample_pdf = lambda *a, **k: z_rows
    try:
        yield
    finally:
        renderer.sample_pdf = real


def tiny_overrides(n_devices: int, workspace: str) -> List[str]:
    """JAX's ``dryrun_tiny_cfg`` as trainer overrides: the synthetic scene
    (2 images of 16x16 each split), 8 N rays of 8 + 8 samples, float32, 2
    epochs of 2 steps, validation every epoch, no ESS, the plain versions,
    ``mesh_devices`` N, the outputs under ``workspace``."""
    pairs = {
        "train_dataset_module": "synthetic", "test_dataset_module": "synthetic",
        "train_dataset.H": 16, "train_dataset.W": 16, "train_dataset.n_images": 2,
        "test_dataset.H": 16, "test_dataset.W": 16, "test_dataset.n_images": 2,
        "task_arg.N_rays": 8 * n_devices, "task_arg.N_samples": 8,
        "task_arg.N_importance": 8, "network.dtype": "float32", "train.epoch": 2,
        "ep_iter": 2, "scan_chunk": 2, "log_interval": 1, "save_latest_ep": 100,
        "save_ep": 100, "eval_ep": 1, "enable_ess": False, "use_pallas_kernels": False,
        "render_tile_rays": 64, "mesh_devices": n_devices,
        "trained_model_dir": os.path.join(workspace, "trained_model"),
        "record_dir": os.path.join(workspace, "record"),
        "result_dir": os.path.join(workspace, "result"),
    }
    return [str(x) for kv in pairs.items() for x in kv]


def trained_params(overrides: Sequence[str], device: Optional[str] = None):
    """Train through ``python -m nerf_tpu_torch.train``'s ``main``, which
    starts the ranks that ``mesh_devices`` asks for, then read the final
    checkpoint back: (params, step)."""
    from ..train import __main__ as cli
    from ..train.checkpoint import load_checkpoint
    from ..train.loop import init_nerf_params
    from ..train.optim import make_optimizer
    from ..train.state import init_state

    cli.main([*(["--device", device] if device else []), *overrides])
    cfg = make_cfg(None, list(overrides))
    opts = RenderOptions.from_cfg(cfg)
    template = init_state(init_nerf_params(torch.Generator().manual_seed(0), opts),
                          make_optimizer(cfg))
    state, _, _ = load_checkpoint(cfg.trained_model_dir, template)
    return state.params, state.step


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> Dict[str, float]:
    """JAX's two 1-vs-N checks (see the module docstring); returns their
    largest differences. Raises AssertionError when one fails."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for world in (n_devices, 1):
            over = tiny_overrides(world, os.path.join(tmp, f"ws{world}"))
            over[over.index("task_arg.N_rays") + 1] = str(8 * n_devices)  # one global batch
            runs[world] = trained_params(over, device)
        for world, (params, step) in runs.items():
            assert step == 4, f"world {world}: {step} steps, expected 4"
            assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)), \
                f"world {world}: non-finite params"
        w_n, w_1 = (runs[w][0]["coarse"]["pts_linears"][0]["w"].detach() for w in (n_devices, 1))
        out["trained_max_diff"] = float((w_n - w_1).abs().max())
        assert out["trained_max_diff"] <= TRAINED_ATOL, out
        print(f"dryrun_multichip({n_devices}): ok, trained 4 steps through "
              f"nerf_tpu_torch.train at world {n_devices}; 1-vs-{n_devices} first-layer "
              f"weights max|dw| = {out['trained_max_diff']:.2e} <= {TRAINED_ATOL}", flush=True)

        path = os.path.join(tmp, "ep.npz")
        np.savez(path, **ep_inputs(n_devices))
        launch("nerf_tpu_torch.parallel.dryrun",
               ["ep", path, path + ".out.npz", *(["--device", device] if device else [])],
               n_devices, resolve_device(device).type)
        with np.load(path + ".out.npz") as res, np.load(path) as inp:
            ep, dense = res["raw_0"], res["dense"]
            assert inp["pts"].shape[0] == ep.shape[0]
        out["ep_max_diff"] = float(np.abs(ep - dense).max())
        np.testing.assert_allclose(ep, dense, rtol=EP_TOL, atol=EP_TOL)
        print(f"dryrun_multichip({n_devices}): KiloNeRF EP over {n_devices} ranks matches "
              f"dense kilonerf_eval (max|d| = {out['ep_max_diff']:.2e} <= {EP_TOL})", flush=True)
    return out


def ep_inputs(n_devices: int, seed: int = 0) -> Dict[str, Any]:
    """The dryrun's EP case: 64 networks of hidden width 16 (``init_kilonerf``
    seed 3), 64 N uniform points and unit directions, capacities of all of
    them, and the dense evaluation to hold it to."""
    cfg = KiloConfig(grid_size=4, hidden=16)
    params = init_kilonerf(torch.Generator().manual_seed(3), cfg)
    rng = np.random.RandomState(seed)
    P = 64 * n_devices
    pts = rng.uniform(cfg.bbox_min, cfg.bbox_max, (P, 3)).astype(np.float32)
    d = rng.randn(P, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dense = kilonerf_eval(params, torch.from_numpy(pts), torch.from_numpy(d), cfg, capacity=P)
    return {"cfg": json.dumps(cfg._asdict()), "pts": pts, "dirs": d,
            "capacities": np.array([[P, P]]), "grads": np.array([False]),
            "dense": dense.numpy(), **kilo_leaves(params)}


def kilo_leaves(params) -> Dict[str, np.ndarray]:
    return {f"{k}_{n}": params[k][n].detach().cpu().numpy() for k in LAYERS for n in ("w", "b")}


def _rank_start(device: Optional[str], backend: Optional[str] = None):
    init_distributed(device=device, backend=backend)
    return data_group(device, owned=True)


def step_case(inp: str, out: str, device: Optional[str] = None) -> None:
    """A rank's side of one data-parallel step: the train state of the
    checkpoint in ``inp["ckpt"]`` (its config ``inp["cfg_file"]`` with the
    overrides ``inp["overrides"]``, its optimizer), the global rays, targets
    and fine samples of ``inp`` (the rank's rows of them), one
    ``apply_step`` with ``inp["opts"]``; rank 0 writes the stats and the
    updated params to ``out``."""
    from ..train.checkpoint import load_checkpoint
    from ..train.loop import init_nerf_params
    from ..train.optim import make_optimizer
    from ..train.state import apply_step, init_state

    group = _rank_start(device)
    try:
        dev = group.device
        with np.load(inp) as data:
            kw = json.loads(str(data["opts"]))
            opts = RenderOptions(**{**kw, "skips": tuple(kw["skips"])})
            cfg = make_cfg(str(data["cfg_file"]), [str(x) for x in data["overrides"]])
            ckpt = str(data["ckpt"])
            batch = [torch.from_numpy(data[k]).to(dev) for k in ("rays_o", "rays_d", "target")]
            z_fine = torch.from_numpy(data["z_fine"]).to(dev)
        tx = make_optimizer(cfg)
        template = init_state(init_nerf_params(torch.Generator().manual_seed(0), opts, dev), tx)
        state = load_checkpoint(ckpt, template)[0]
        with fed_fine_samples(z_fine[group.rows(z_fine.shape[0])]):
            stats = apply_step(state, *batch, tx, opts, None, None, group)
        if is_main_process():
            np.savez(out, **{k: float(v) for k, v in stats.items()},
                     **{f"leaf_{i}": t.detach().cpu().numpy()
                        for i, t in enumerate(tree_leaves(state.params))})
    finally:
        destroy(group)


def ep_case(inp: str, out: str, device: Optional[str] = None) -> None:
    """A rank's side of ``kilonerf_eval_ep``: ``inp`` holds the full
    KiloNeRF leaves, the global points and directions, and the cases'
    (send, expert) capacities and whether to differentiate; each rank takes
    its networks and rows. Rank 0 writes every case's gathered outputs
    (``raw_<i>``) and gradients of sum(raw * cot) (``grad_<i>_<leaf>``),
    and the dense evaluation it was given."""
    from .kilonerf_ep import kilonerf_eval_ep, shard_kilonerf_params

    group = _rank_start(device)
    try:
        dev = group.device
        with np.load(inp) as data:
            cfg = KiloConfig(**json.loads(str(data["cfg"])))
            full = {k: {n: torch.from_numpy(data[f"{k}_{n}"]).to(dev).requires_grad_(True)
                        for n in ("w", "b")} for k in LAYERS}
            pts, dirs = (torch.from_numpy(data[k]).to(dev) for k in ("pts", "dirs"))
            cot = torch.from_numpy(data["cot"]).to(dev) if "cot" in data else None
            cases = [(int(s), int(e), bool(g)) for (s, e), g in zip(data["capacities"],
                                                                    data["grads"])]
            results = {"dense": data["dense"]} if "dense" in data else {}
        local = shard_kilonerf_params(full, group)
        pts_l, dirs_l = shard_batch(group, (pts, dirs))
        for i, (send, expert, grads) in enumerate(cases):
            raw = kilonerf_eval_ep(local, pts_l, dirs_l, cfg, group, send, expert)
            results[f"raw_{i}"] = gather_to_main(raw.detach()).reshape(-1, 4).cpu().numpy()
            if grads:
                loss = (raw * shard_batch(group, cot)).sum()
                names = [(k, n) for k in LAYERS for n in ("w", "b")]
                g = torch.autograd.grad(loss, [local[k][n] for k, n in names])
                for (k, n), t in zip(names, g):
                    results[f"grad_{i}_{k}_{n}"] = gather_to_main(t).flatten(0, 1).cpu().numpy()
        if is_main_process():
            np.savez(out, **results)
    finally:
        destroy(group)


def collectives_case(out: str, device: Optional[str] = None,
                     backend: Optional[str] = None) -> None:
    """A rank's side of the multihost checks: rank r broadcasts a tree of
    r-valued leaves (a float tensor, an int numpy array, a bool tensor),
    gathers [r, 2 r], averages r and 2 r with ``all_reduce_mean``,
    ``replicate``s [1 + r, 1 + r] in place, passes a barrier, and writes what it received to ``out.<r>.npz``. (``backend``
    gloo on CUDA: whether gloo takes the card's tensors.)"""
    from .mesh import all_reduce_mean, replicate
    from .multihost import barrier, broadcast_from_main, process_count, process_index

    group = _rank_start(device, backend)
    try:
        r = process_index()
        tree = {"f": torch.full((3,), float(r), device=group.device),
                "i": np.full((2, 2), r, np.int64),
                "b": torch.tensor([r == 0, r != 0], device=group.device)}
        got = broadcast_from_main(tree)
        gathered = gather_to_main(torch.tensor([r, 2 * r], device=group.device))
        mean = all_reduce_mean([torch.tensor(float(r), device=group.device),
                                torch.tensor([2.0 * r], dtype=torch.bfloat16,
                                             device=group.device)])
        replicated = replicate(group, {"w": torch.full((2,), 1.0 + r, device=group.device)})
        barrier("collectives")
        np.savez(f"{out}.{r}.npz", f=got["f"].cpu().numpy(), i=got["i"], b=got["b"].cpu().numpy(),
                 gathered=gathered.cpu().numpy(), mean0=mean[0].cpu().numpy(),
                 mean1=mean[1].float().cpu().numpy(), world=process_count(),
                 replicated=replicated["w"].cpu().numpy(),
                 b_dtype=str(got["b"].dtype), mean1_dtype=str(mean[1].dtype))
    finally:
        destroy(group)


def opts_json(opts: RenderOptions) -> str:
    """RenderOptions as the ``step`` command reads them."""
    return json.dumps(dataclasses.asdict(opts))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("command", nargs="?", default="dryrun",
                        choices=["dryrun", "step", "ep", "collectives"])
    parser.add_argument("paths", nargs="*", help="step / ep: the input and output .npz")
    parser.add_argument("--devices", type=int, default=2)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--backend", default=None, help="collectives: gloo or nccl")
    args = parser.parse_args(argv)
    if args.command == "step":
        step_case(*args.paths, device=args.device)
    elif args.command == "ep":
        ep_case(*args.paths, device=args.device)
    elif args.command == "collectives":
        collectives_case(*args.paths, device=args.device, backend=args.backend)
    else:
        dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
