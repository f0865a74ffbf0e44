"""Reference-checkpoint CLI; counterpart of ``scripts/port_torch_checkpoint.py``.

    python -m nerf_tpu_torch.port_torch_checkpoint --cfg_file configs/nerf/lego.yaml \\
        path/to/latest.pth [key value ...]

Reads the reference ``{net, optim, scheduler, recorder, epoch}`` ``.pth``
(``utils/torch_port.py``), puts the coarse and fine MLP weights into a fresh
train state (Adam's moments are not ported, as in the JAX package) and
writes ``latest.npz`` into ``trained_model_dir``, the checkpoint that
``python -m nerf_tpu_torch.run``, ``serve`` and ``train`` (resume) read.
Host only: nothing runs on the card.
"""
from __future__ import annotations

import sys
from typing import List, Optional

from .config import make_cfg
from .render.renderer import RenderOptions
from .train.checkpoint import save_checkpoint
from .train.optim import make_optimizer
from .train.state import init_state
from .utils.torch_port import load_reference_checkpoint, read_reference_checkpoint


def port_checkpoint(cfg, pth_path: str) -> int:
    """Write ``pth_path``'s weights as ``<cfg.trained_model_dir>/latest.npz``;
    returns the epoch it records. Raises ``ValueError`` when the weights do
    not have the shapes ``cfg``'s model needs."""
    opts = RenderOptions.from_cfg(cfg)
    if opts.network_type != "nerf" or opts.hashgrid:
        raise ValueError("a reference checkpoint holds the frequency NeRF's MLPs only")
    params = load_reference_checkpoint(pth_path, D=opts.mlp_depth,
                                       use_viewdirs=opts.use_viewdirs)
    w0 = params["coarse"]["pts_linears"][0]["w"]
    if tuple(w0.shape) != (opts.input_ch, opts.mlp_width):
        raise ValueError(f"{pth_path}: the first layer is {tuple(w0.shape)}, the config's "
                         f"model needs ({opts.input_ch}, {opts.mlp_width})")
    epoch = int(read_reference_checkpoint(pth_path).get("epoch", 0))
    save_checkpoint(cfg.trained_model_dir, init_state(params, make_optimizer(cfg)), epoch)
    return epoch


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    paths = [a for a in argv if a.endswith(".pth")]
    if len(paths) != 1:
        raise SystemExit("usage: python -m nerf_tpu_torch.port_torch_checkpoint "
                         "--cfg_file <yaml> <checkpoint.pth> [key value ...]")
    argv.remove(paths[0])
    cfg_file = None
    if "--cfg_file" in argv:
        i = argv.index("--cfg_file")
        cfg_file = argv[i + 1]
        del argv[i:i + 2]
    cfg = make_cfg(cfg_file, argv)
    epoch = port_checkpoint(cfg, paths[0])
    print(f"ported {paths[0]} (epoch {epoch}) -> {cfg.trained_model_dir}/latest.npz")
    return epoch


if __name__ == "__main__":
    main()
