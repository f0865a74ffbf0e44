"""Trainer CLI; counterpart of the top-level ``train.py`` for the nerf task.

    python -m nerf_tpu_torch.train --cfg_file configs/nerf/lego.yaml [key value ...]

Runs on CUDA; ``--device cpu`` runs the plain PyTorch versions on the CPU.
``auto_restart N`` resumes from the latest checkpoint after up to N failures.
``--test`` evaluates the checkpoint in ``trained_model_dir`` instead
(``run.run_evaluate``). The img_fit task is not ported.
"""
from __future__ import annotations

import argparse
import sys
import traceback

from ..config import make_cfg
from .loop import train


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


def main(argv=None):
    cfg, args = parse_args(argv)
    if cfg.task != "nerf":
        raise NotImplementedError(f"task {cfg.task!r} is not ported")
    if args.test:
        from ..run import run_evaluate

        return run_evaluate(cfg, device=args.device)
    max_restarts = int(cfg.get("auto_restart", 0))
    attempt = 0
    while True:
        try:
            return train(cfg, device=args.device)
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
