"""How large the hash-grid step's gradients are, leaf by leaf, and how far
the kernel path and bf16 move each: the quantities behind ``chip_smoke.py``
phase 13's gate, over several trainings and batches.

    python -m nerf_tpu_torch.tools.hash_grad_scale [--trainings 3] [--batches 3]

Each training is phase 11's: ``configs/nerf/lego_hashgrid_cellpack.yaml``
from ``init_hashgrid`` tables through the trainer's ``main``, one epoch cut
to 200 steps on the synthetic scene (100 images, 800x800), in a temp
directory. Then, as phase 13 does, random colours at 8 orbit poses, and for
each batch (generator seeds 1.. ; 1 is phase 13's) one step's gradients
through the kernels, through the plain versions, and through the plain
versions with float32 MLP weights. For the leaves of ``alpha_linear`` (the
density head: 0, 1 coarse, 17, 18 fine) and the largest leaf it prints the
norm of the plain gradient and, relative to it, the kernel path's distance
and bf16's (plain against float32). Phase 13 holds a leaf to max(1e-2,
2 x the second) in relative distance, or, below ``HASH_SMALL_LEAF`` (1e-4)
of the largest leaf's norm, in absolute distance scaled by that norm; these
figures chose that line. The card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import subprocess
import tempfile

import torch

from ..config import make_cfg
from ..render.renderer import RenderOptions
from ..serve import RenderService, look_at_pose
from ..train.__main__ import main as train_main
from ..train.state import loss_and_grads, sample_ray_batch

CFG = "configs/nerf/lego_hashgrid_cellpack.yaml"
TRAIN = ["train_dataset_module", "synthetic", "train_dataset.n_images", "100",
         "train_dataset.H", "800", "train_dataset.W", "800", "train.epoch", "1",
         "ep_iter", "200", "grid_rebuild_ep", "1", "save_latest_ep", "1"]
LEAVES = (0, 1, 17, 18)


def _views(service, dev, n_views=8):
    poses = torch.stack([torch.as_tensor(look_at_pose(2.0 * math.pi * i / n_views, 0.3, 4.0))
                         for i in range(n_views)]).to(dev)
    imgs = torch.randint(0, 256, (n_views, service.size, service.size, 3), dtype=torch.uint8,
                         device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    return imgs, poses, service.K


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--trainings", type=int, default=3)
    parser.add_argument("--batches", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hash_grad_scale: needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for t in range(args.trainings):
        with tempfile.TemporaryDirectory() as tmp:
            opts_cli = [*TRAIN, "trained_model_dir", f"{tmp}/model", "record_dir", f"{tmp}/rec"]
            state, _ = train_main(["--cfg_file", CFG, *opts_cli])
            cfg = make_cfg(CFG, opts_cli)
            service = RenderService(cfg, size=200, device=dev)
        data = _views(service, dev)
        opts = RenderOptions.from_cfg(cfg)
        plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
        paths = {"kernel": opts, "plain": plain,
                 "plain32": dataclasses.replace(plain, compute_dtype="float32")}
        for seed in range(1, args.batches + 1):
            gen = torch.Generator(device=dev).manual_seed(seed)
            ro, rd, tgt = sample_ray_batch(gen, *data, int(cfg.task_arg.N_rays))
            rng = gen.get_state()
            grads = {}
            for name, o in paths.items():
                gen.set_state(rng)
                grads[name] = loss_and_grads(state.params, ro, rd, tgt, o, service.grid, gen)[2]
            norms = [float(g.double().norm()) for g in grads["plain"]]
            big = max(range(len(norms)), key=norms.__getitem__)
            parts = []
            for i in (*LEAVES, big):
                k, p, q = (grads[n][i].double() for n in ("kernel", "plain", "plain32"))
                kernel = float((k - p).norm()) / norms[i]
                bf16 = float((p - q).norm() / q.norm().clamp_min(1e-30))
                parts.append(f"leaf {i}: |g| {norms[i]:.3g}, kernel {kernel:.3g}, bf16 {bf16:.3g}")
            print(f"training {t} batch {seed}: " + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
