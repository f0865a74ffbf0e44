"""The img_fit training loop and evaluation; counterpart of ``nerf_tpu/train/img_fit_loop.py``.

A step draws ``N_pixels`` pixels uniformly with replacement, from a
``torch.Generator`` seeded with (seed, step) as JAX folds the step into its
key, so a resumed run draws what an uninterrupted one would; the loss is
the MSE of the sigmoid RGB, psnr = -10 log10(MSE), and the update is the
port's ``make_optimizer`` (clip 40, Adam, exponential decay), in place. An
epoch is ``ep_iter`` steps; checkpoints every ``save_latest_ep`` epochs and
at the end, in the JAX package's layout (``train/checkpoint.py``: head{b, w},
layers[i]{b, w}, Adam's count, mu, nu, the schedule's count, the step).

``eval_img_fit`` predicts the whole image, prints and returns its PSNR, and
writes ``metrics.json`` and ``gt_pred.png`` (ground truth | prediction)
into ``result_dir``; the JAX package writes ``gt_pred.jpg`` through
imageio, which the card's machine does not have.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.img_fit import ImgFitDataset, make_img_fit_dataset
from ..device import resolve_device
from ..eval.metrics import psnr as psnr_fn
from ..models.img_fit import apply_img_fit_mlp, init_img_fit_mlp
from ..tree import tree_leaves, tree_map
from ..utils.png import write_png
from .checkpoint import load_checkpoint, save_checkpoint
from .optim import Optimizer, make_optimizer
from .state import TrainState, init_state


def _shape(cfg):
    net = cfg.network
    return dict(D=int(net.get("mlp", {}).get("D", 4)), W=int(net.get("mlp", {}).get("W", 128)),
                num_freqs=int(net.get("uv_encoder", {}).get("freq", 10)))


def img_fit_step(state: TrainState, uv_all: torch.Tensor, rgb_all: torch.Tensor,
                 tx: Optimizer, num_freqs: int, n_pixels: int,
                 generator: Optional[torch.Generator] = None,
                 idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One step on ``n_pixels`` pixels (``idx`` when given, else drawn from
    ``generator``); updates ``state`` in place and returns its loss and psnr
    as device tensors."""
    if idx is None:
        idx = torch.randint(0, uv_all.shape[0], (n_pixels,), generator=generator,
                            device=uv_all.device)
    params = tree_leaves(state.params)
    pred = apply_img_fit_mlp(state.params, uv_all[idx], num_freqs=num_freqs)
    mse = torch.mean((pred - rgb_all[idx]) ** 2)
    grads = torch.autograd.grad(mse, params)
    tx.step(params, grads, state.opt_state)
    state.step += 1
    mse = mse.detach()
    return {"loss": mse, "psnr": -10.0 * torch.log10(mse)}


def template_state(cfg, dev, seed: int = 0) -> TrainState:
    """A run's first state (the MLP drawn from ``seed``, the optimizer's
    fresh state), on ``dev``: also the template its checkpoints load into."""
    params = init_img_fit_mlp(torch.Generator().manual_seed(seed), device=dev, **_shape(cfg))
    params = tree_map(lambda t: t.requires_grad_(True), params)
    return init_state(params, make_optimizer(cfg))


def train_img_fit(cfg, max_epochs: Optional[int] = None, device=None):
    """Train (resuming from ``trained_model_dir`` unless ``resume`` is off);
    returns (state, dataset)."""
    dev = resolve_device(device)
    num_freqs = _shape(cfg)["num_freqs"]
    ds = make_img_fit_dataset(cfg)
    uv_all = torch.from_numpy(ds.uv).to(dev)
    rgb_all = torch.from_numpy(ds.rgb).to(dev)
    seed = int(cfg.get("seed", 0))
    tx = make_optimizer(cfg)
    state = template_state(cfg, dev, seed)
    model_dir = cfg.trained_model_dir
    begin_epoch = 0
    ckpt = load_checkpoint(model_dir, state) if cfg.get("resume", True) else None
    if ckpt is not None:
        state, begin_epoch, _ = ckpt
        begin_epoch += 1

    gen = torch.Generator(device=dev)
    ep_iter = int(cfg.get("ep_iter", 100))
    end_epoch = int(cfg.train.epoch) if max_epochs is None else begin_epoch + max_epochs
    for epoch in range(begin_epoch, end_epoch):
        t0 = time.time()
        for _ in range(ep_iter):
            gen.manual_seed((seed << 32) + state.step)  # JAX's fold_in(key, step)
            stats = img_fit_step(state, uv_all, rgb_all, tx, num_freqs, ds.n_pixels, gen)
        stats = {k: float(v) for k, v in stats.items()}
        print(f"epoch {epoch}  loss: {stats['loss']:.5f}  psnr: {stats['psnr']:.2f}"
              f"  ({time.time() - t0:.2f}s)", flush=True)
        if (epoch + 1) % int(cfg.get("save_latest_ep", 10)) == 0:
            save_checkpoint(model_dir, state, epoch)
    save_checkpoint(model_dir, state, end_epoch - 1)
    return state, ds


def eval_img_fit(cfg, state: Optional[TrainState] = None, ds: Optional[ImgFitDataset] = None,
                 device=None) -> float:
    """The whole image's PSNR against the checkpoint in ``trained_model_dir``
    (or ``state``); writes ``gt_pred.png`` and ``metrics.json``. Raises
    ``FileNotFoundError`` when there is no checkpoint."""
    dev = resolve_device(device)
    ds = make_img_fit_dataset(cfg) if ds is None else ds
    if state is None:
        ckpt = load_checkpoint(cfg.trained_model_dir, template_state(cfg, dev))
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint in {cfg.trained_model_dir}")
        state = ckpt[0]
    with torch.no_grad():
        pred = apply_img_fit_mlp(state.params, torch.from_numpy(ds.uv).to(dev),
                                 num_freqs=_shape(cfg)["num_freqs"])
    pred = pred.cpu().numpy().reshape(ds.H, ds.W, 3)
    p = psnr_fn(np.clip(pred, 0, 1), ds.image)
    print(f"img_fit eval PSNR: {p:.2f}", flush=True)
    os.makedirs(cfg.result_dir, exist_ok=True)
    concat = np.concatenate([ds.image, np.clip(pred, 0, 1)], axis=1)
    write_png(os.path.join(cfg.result_dir, "gt_pred.png"), (concat * 255).astype(np.uint8))
    with open(os.path.join(cfg.result_dir, "metrics.json"), "w") as f:
        json.dump({"psnr": float(p)}, f)
    return p
