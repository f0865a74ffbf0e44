"""Compositing kernel; counterpart of ``nerf_tpu/ops/integrate.py``.

``integrate`` launches the CUDA kernel ``csrc/integrate.cu`` (the port of
the Pallas ``_integrate_kernel``, ``nerf_tpu/ops/integrate.py:24``) on CUDA
tensors and runs ``integrate_plain``, the same math in plain PyTorch, on
CPU tensors. Their transmittance is the Pallas kernel's: an exclusive sum of
log(1 - alpha + 1e-10), each term a stable logaddexp, rather than the
cumprod of ``render/composite.py``; both agree with it to float32 rounding.

``composite_kernel`` is differentiable (the counterpart of ``nerf_tpu``'s
``_composite_pallas_diff``): its forward is ``integrate``, and its backward
recomputes ``render/composite.py::composite`` under torch autograd, as the
JAX package recomputes through XLA. The JAX package has no backward kernel
for compositing, so neither has the port.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from ..render.composite import composite, finish_maps
from . import build

_LOG_EPS = -23.025850929940457  # log(1e-10)
_ACTIVATIONS = ("relu", "softplus")


def integrate_plain(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                    ert_threshold: float = 0.0, white_bkgd: bool = True,
                    sigma_activation: str = "relu") -> Dict[str, torch.Tensor]:
    """raw [N, S, 4], z_vals [N, S], rays_d [N, 3] -> rgb_map, depth_map,
    acc_map, disp_map, weights. ``ert_threshold <= 0`` turns ERT off."""
    if sigma_activation not in _ACTIVATIONS:
        raise ValueError(f"unknown sigma activation: {sigma_activation!r}")
    sigma = raw[..., 3]
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full_like(z_vals[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dens = torch.clamp_min(sigma, 0.0)
    if sigma_activation == "softplus":  # in the kernel's form
        dens = dens + torch.log(1.0 + torch.exp(-torch.abs(sigma)))
    lam = dens * dists
    alpha = 1.0 - torch.exp(-lam)
    hi = torch.clamp_min(-lam, _LOG_EPS)
    lo = torch.clamp_max(-lam, _LOG_EPS)
    log_1ma = hi + torch.log(1.0 + torch.exp(lo - hi))
    excl = torch.cumsum(torch.cat([torch.zeros_like(log_1ma[:, :1]), log_1ma[:, :-1]], -1), -1)
    trans = torch.exp(excl)
    weights = alpha * trans
    if ert_threshold > 0:
        weights = weights * (trans >= ert_threshold).to(weights.dtype)
    rgb_map = torch.sum(torch.sigmoid(raw[..., :3]) * weights[..., None], dim=-2)
    out = finish_maps(rgb_map, torch.sum(weights * z_vals, -1), torch.sum(weights, -1),
                      white_bkgd)
    out["weights"] = weights
    return out


def integrate(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
              ert_threshold: float = 0.0, white_bkgd: bool = True,
              sigma_activation: str = "relu") -> Dict[str, torch.Tensor]:
    """``integrate_plain``'s function: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Forward only: inputs that require grad
    raise (``composite_kernel`` differentiates)."""
    if raw.requires_grad or z_vals.requires_grad or rays_d.requires_grad:
        raise RuntimeError("integrate is forward-only; use composite_kernel for gradients")
    if raw.device.type == "cpu":
        return integrate_plain(raw, z_vals, rays_d, ert_threshold, white_bkgd,
                               sigma_activation)
    if sigma_activation not in _ACTIVATIONS:
        raise ValueError(f"unknown sigma activation: {sigma_activation!r}")
    N, S = z_vals.shape
    if N > build.MAX_LAUNCH_ROWS or S > build.MAX_LAUNCH_ROWS:
        raise ValueError(f"[{N}, {S}] samples in one call; split the rays")
    build.check_cuda("raw", raw, torch.float32, (N, S, 4), align=16)
    build.check_cuda("z_vals", z_vals, torch.float32, (N, S))
    build.check_cuda("rays_d", rays_d, torch.float32, (N, 3))
    kw = dict(dtype=torch.float32, device=raw.device)
    rgb_map = torch.empty((N, 3), **kw)
    depth = torch.empty((N,), **kw)
    acc = torch.empty((N,), **kw)
    weights = torch.empty((N, S), **kw)
    rc = _lib().launch_integrate(
        raw.data_ptr(), z_vals.data_ptr(), rays_d.data_ptr(), rgb_map.data_ptr(),
        depth.data_ptr(), acc.data_ptr(), weights.data_ptr(), N, S,
        float(ert_threshold), int(sigma_activation == "softplus"),
        torch.cuda.current_stream(raw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"integrate kernel launch failed: CUDA error {rc}")
    integrate.launches += 1
    out = finish_maps(rgb_map, depth, acc, white_bkgd)
    out["weights"] = weights
    return out


integrate.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("integrate")
    p = ctypes.c_void_p
    lib.launch_integrate.argtypes = [p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int, p]
    lib.launch_integrate.restype = ctypes.c_int
    return lib


_OUTPUTS = ("rgb_map", "depth_map", "acc_map", "disp_map", "weights")


class _Composite(torch.autograd.Function):
    """Forward: ``integrate`` (or its plain version). Backward: the vjp of
    ``composite`` with the same options, recomputed under autograd."""

    @staticmethod
    def forward(ctx, raw, z_vals, rays_d, white_bkgd, ert_threshold, sigma_activation, plain):
        fn = integrate_plain if plain else integrate
        out = fn(raw.detach(), z_vals.detach(), rays_d.detach(), ert_threshold=ert_threshold,
                 white_bkgd=white_bkgd, sigma_activation=sigma_activation)
        ctx.save_for_backward(raw, z_vals, rays_d)
        ctx.opts = (white_bkgd, ert_threshold, sigma_activation)
        return tuple(out[k] for k in _OUTPUTS)

    @staticmethod
    def backward(ctx, *grads):
        white_bkgd, ert, act = ctx.opts
        needs = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = composite(*inputs, white_bkgd=white_bkgd,
                            ert_threshold=ert if ert > 0 else None, sigma_activation=act)
            wanted = [t for t, n in zip(inputs, needs) if n]
            got = iter(torch.autograd.grad([out[k] for k in _OUTPUTS], wanted, grads,
                                           allow_unused=True))
        return (*(next(got) if n else None for n in needs), None, None, None, None)


def composite_kernel(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor, *,
                     white_bkgd: bool = True, ert_threshold: float = 0.0,
                     sigma_activation: str = "relu", plain: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """Drop-in for ``render.composite.composite`` (noise-free), through the
    kernel (``plain=True``: through its plain version on any device).
    Differentiable in raw, z_vals and rays_d."""
    out = _Composite.apply(raw, z_vals, rays_d, white_bkgd, float(ert_threshold),
                           sigma_activation, plain)
    return dict(zip(_OUTPUTS, out))
