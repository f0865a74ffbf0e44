"""Trainer CLI; counterpart of the top-level ``train.py`` for the nerf task.

    python -m nerf_tpu_torch.train --cfg_file configs/nerf/lego.yaml [key value ...]

Runs on CUDA; ``--device cpu`` runs the plain PyTorch versions on the CPU.
``auto_restart N`` resumes from the latest checkpoint after up to N failures.

Data parallelism: when JAX's rule (``loop.make_train_mesh``: the cards, or
on the CPU ``mesh_devices`` gloo ranks, capped by ``mesh_devices`` and
lowered until they divide ``N_rays``; 1 with ``train_full_image``) gives a
world of N > 1 and the process
is not a rank already (no ``WORLD_SIZE``), it starts N ranks of itself with
``distributed True`` and waits for them; under torchrun (``distributed
True``) it is one rank of the launcher's world.
``--test`` evaluates the checkpoint in ``trained_model_dir`` instead
(``run.run_evaluate``). The last line a nerf training prints (rank 0's) is
its kernel launches, as ``run``'s frames'.

The img_fit task (``task: img_fit``, ``configs/img_fit/lego_view0.yaml``)
trains through ``train.img_fit_loop.train_img_fit`` on one device, as the
top-level ``train.py`` dispatches it; ``--test`` evaluates it.
"""
from __future__ import annotations

import argparse
import os
import sys
import traceback

from ..config import make_cfg
from ..device import resolve_device
from ..parallel.mesh import launch
from .loop import train, trainer_world


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="nerf_tpu_torch trainer")
    parser.add_argument("--cfg_file", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--det", action="store_true", help="seed 42, as fix_random")
    parser.add_argument("--test", action="store_true", help="evaluate instead of training")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    cfg = make_cfg(args.cfg_file, args.opts)
    if cfg.get("fix_random", False) or args.det:
        cfg["seed"] = 42
    return cfg, args


def launches() -> dict:
    """Each CUDA wrapper's launch count so far (a wrapper counts the launches
    of its kernel, on CUDA tensors only)."""
    from ..ops import fused_mlp, fused_mlp_bwd, hash_gather, integrate

    return {"fused_nerf_eval": fused_mlp.fused_nerf_eval.launches,
            "fused_nerf_bwd": fused_mlp_bwd.fused_nerf_bwd.launches,
            "fused_nerf_eval_f32": fused_mlp.fused_nerf_eval_f32.launches,
            "fused_nerf_bwd_f32": fused_mlp_bwd.fused_nerf_bwd_f32.launches,
            "integrate": integrate.integrate.launches,
            "hash_gather_rows": hash_gather.gather_rows.launches,
            "hash_scatter_add_rows": hash_gather.scatter_add_rows.launches}


def main(argv=None):
    cfg, args = parse_args(argv)
    if cfg.task not in ("nerf", "img_fit"):
        raise NotImplementedError(f"task {cfg.task!r} is not ported")
    if args.test:
        from ..run import run_evaluate

        return run_evaluate(cfg, device=args.device)
    if cfg.task == "img_fit":
        from .img_fit_loop import train_img_fit

        return train_img_fit(cfg, device=args.device)
    if "WORLD_SIZE" not in os.environ:
        dev = resolve_device(args.device)
        world = trainer_world(cfg, dev)
        if world > 1:
            rank_argv = ["--cfg_file", args.cfg_file] if args.cfg_file else []
            rank_argv += (["--device", args.device] if args.device else []) + (
                ["--det"] if args.det else [])
            print(f"starting {world} ranks", flush=True)
            launch("nerf_tpu_torch.train", rank_argv + list(args.opts) + ["distributed", "True"],
                   world, dev.type)
            return None
    max_restarts = int(cfg.get("auto_restart", 0))
    attempt = 0
    before = launches()
    while True:
        try:
            out = train(cfg, device=args.device)
            if int(os.environ.get("RANK", 0)) == 0:
                print("kernel launches: " + ", ".join(f"{k} {v - before[k]}"
                                                      for k, v in launches().items()), flush=True)
            return out
        except (RuntimeError, FloatingPointError) as e:
            attempt += 1
            if attempt > max_restarts:
                raise
            traceback.print_exc()
            print(f"[auto_restart] attempt {attempt}/{max_restarts}: resuming from the "
                  f"latest checkpoint after {type(e).__name__}", flush=True)
            cfg["resume"] = True


if __name__ == "__main__":
    main(sys.argv[1:])
