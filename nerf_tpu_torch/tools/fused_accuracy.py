"""How far bf16 rounding alone moves the fused MLP's outputs, on the serving
path's own inputs, beside how far the CUDA kernel is from its plain version.

    python -m nerf_tpu_torch.tools.fused_accuracy [--size 200] [--theta 0.5] [key value ...]

Renders the first and the last tile of one 200x200 orbit pose of the lego
model (ESS grid at R=128) and takes one lattice slab of the ESS rebuild,
then evaluates each tile's MLP points four ways on the GPU:
  kernel  the CUDA kernel (bf16 operands, float32 sums on the tensor cores);
  plain   fused_nerf_eval_plain (bf16 operands, float32 sums by cuBLAS);
  plain64 the same with float64 sums: another summation order of the same
          bf16 function;
  f32     fused_nerf_eval_plain on float32 weights and activations.
For each pair it prints the error |a - b| / (1 + |b|): max, 99th and
99.9th percentile, the share above 1e-2, and the worst output. TF32 is off.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..config import make_cfg
from ..ops import fused_mlp
from ..render import occupancy as occ
from ..render.rays import image_rays
from ..render.renderer import render_rays
from ..serve import RenderService, look_at_pose
from ..train.checkpoint import load_params

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHANNELS = ("r", "g", "b", "sigma")


def path_inputs(service: RenderService, theta: float, phi: float = 0.3, radius: float = 4.0):
    """[(label, model, pts [P, 3], dirs [P, 3], z_vals [N, S], rays_d [N, 3])]
    as the serving path hands them to the kernels: the coarse and the fine
    pass of the first and the last render tile of one pose, then the middle
    slab of an ESS rebuild (z_vals and rays_d None: it is not composited)."""
    dev, opts, size = service.device, service.opts, service.size
    pose = torch.as_tensor(look_at_pose(theta, phi, radius), device=dev)
    rays_o, rays_d = image_rays(size, size, service.K, pose)
    n_rays, tile = size * size, opts.tile_rays
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for label, sl in (("first tile", slice(0, tile)),
                      ("last tile", slice((n_rays - 1) // tile * tile, n_rays))):
        o, d = rays_o[sl].contiguous(), rays_d[sl].contiguous()
        out = render_rays(service.params, o, d, opts, grid=service.grid, generator=gen)
        for model in ("coarse", "fine"):
            z = out[f"{model}_z_vals"].contiguous()
            pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3).contiguous()
            dirs = d[:, None, :].expand(-1, z.shape[1], 3).reshape(-1, 3).contiguous()
            cases.append((f"{label} {model}", model, pts, dirs, z, d))
    slabs = []

    def record(pts):
        slabs.append(pts)
        return torch.zeros(pts.shape[0], device=pts.device)

    occ.populate_from_density(service.grid, record)
    slab = slabs[len(slabs) // 2].contiguous()
    cases.append((f"ESS slab {len(slabs) // 2} of {len(slabs)}", "coarse", slab,
                  torch.zeros_like(slab), None, None))
    return cases


def compare(a: torch.Tensor, b: torch.Tensor) -> str:
    err = (a - b).abs()
    rel = err / (1.0 + b.abs())
    flat = rel.flatten()
    q = torch.quantile(flat, torch.tensor([0.99, 0.999], device=flat.device))
    i = int(flat.argmax())
    p, c = divmod(i, a.shape[1])
    return (f"max {float(flat.max()):.4g}, p99 {float(q[0]):.3g}, p99.9 {float(q[1]):.3g}, "
            f"share > 1e-2 {float((flat > 1e-2).float().mean()):.3g}; worst: point {p} "
            f"{CHANNELS[c]} {float(a[p, c]):.5g} vs {float(b[p, c]):.5g}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--size", type=int, default=200)
    parser.add_argument("--theta", type=float, default=0.5)
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="config overrides, as key value pairs")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"),
                   ["trained_model_dir", os.path.join(ROOT, "checkpoints/nerf/lego/nerf"),
                    *args.opts])
    service = RenderService(cfg, size=args.size, device=args.device)
    tree = load_params(cfg.trained_model_dir)
    kp32 = {m: {k: v.to(service.device) for k, v in
                fused_mlp.repack_params(tree[m], weight_dtype=torch.float32).items()}
            for m in ("coarse", "fine")}
    for label, model, pts, dirs, _, _ in path_inputs(service, args.theta):
        kp = service.params[model]
        outs = {"kernel": fused_mlp.fused_nerf_eval(kp, pts, dirs),
                "plain": fused_mlp.fused_nerf_eval_plain(kp, pts, dirs),
                "plain64": fused_mlp.fused_nerf_eval_plain(kp, pts, dirs, torch.float64),
                "f32": fused_mlp.fused_nerf_eval_plain(kp32[model], pts, dirs)}
        print(f"{label}, {pts.shape[0]} points:", flush=True)
        for a, b in (("kernel", "plain"), ("plain64", "plain"), ("kernel", "plain64"),
                     ("kernel", "f32"), ("plain", "f32"), ("plain64", "f32")):
            print(f"  {a:>7} vs {b:<7} {compare(outs[a], outs[b])}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
