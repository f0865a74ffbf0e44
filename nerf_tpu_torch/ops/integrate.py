"""Compositing kernel; counterpart of ``nerf_tpu/ops/integrate.py``.

``integrate`` launches the CUDA kernel ``csrc/integrate.cu`` (the port of
the Pallas ``_integrate_kernel``, ``nerf_tpu/ops/integrate.py:24``) on CUDA
tensors and runs ``integrate_plain``, the same math in plain PyTorch, on
CPU tensors. Their transmittance is the Pallas kernel's: an exclusive sum of
log(1 - alpha + 1e-10), each term a stable logaddexp, rather than the
cumprod of ``render/composite.py``; both agree with it to float32 rounding.

``integrate_warp`` launches the previous kernel (32 samples a round), kept for
comparison; ``lane_transmittance`` repeats the kernel's order of sums in
PyTorch for the CPU tests.

While spans are on (``utils/profiling``: a torch profiler runs), ``integrate``
passes the kernel a device counter of the samples whose weight early ray
termination zeroes (``ert_cut_count``; one block's rays, one atomic add) and
counts the samples it was given on the host (``b3.samples``); off, the
kernel gets a null counter and counts nothing.

``composite_kernel`` is differentiable (the counterpart of ``nerf_tpu``'s
``_composite_pallas_diff``): its forward is ``integrate``, and its backward
recomputes ``render/composite.py::composite`` under torch autograd, as the
JAX package recomputes through XLA. The JAX package has no backward kernel
for compositing, so neither has the port.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch

from ..render.composite import composite, finish_maps
from ..utils import profiling
from . import build

_LOG_EPS = -23.025850929940457  # log(1e-10)
# the density activations, in the order of csrc/integrate.cu's ``act`` codes
_ACTIVATIONS = ("relu", "softplus", "exp")
_MAX_K, _CHUNK_K = 8, 2  # csrc/integrate.cu's MAX_K and CHUNK_K


def sample_terms(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                 sigma_activation: str = "relu"):
    """Per sample, alpha and log(1 - alpha + 1e-10) (a stable logaddexp), as
    the kernel forms them: raw [N, S, 4], z_vals [N, S], rays_d [N, 3] ->
    two [N, S] tensors. The density is relu(sigma), softplus(sigma) as
    max(sigma, 0) + log(1 + exp(-|sigma|)), or exp(sigma)."""
    if sigma_activation not in _ACTIVATIONS:
        raise ValueError(f"unknown sigma activation: {sigma_activation!r}")
    sigma = raw[..., 3]
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full_like(z_vals[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if sigma_activation == "exp":
        dens = torch.exp(sigma)
    else:
        dens = torch.clamp_min(sigma, 0.0)
        if sigma_activation == "softplus":  # in the kernel's form
            dens = dens + torch.log(1.0 + torch.exp(-torch.abs(sigma)))
    lam = dens * dists
    hi = torch.clamp_min(-lam, _LOG_EPS)
    lo = torch.clamp_max(-lam, _LOG_EPS)
    return 1.0 - torch.exp(-lam), hi + torch.log(1.0 + torch.exp(lo - hi))


def _exclusive_exp(log_1ma: torch.Tensor) -> torch.Tensor:
    excl = torch.cumsum(torch.cat([torch.zeros_like(log_1ma[:, :1]), log_1ma[:, :-1]], -1), -1)
    return torch.exp(excl)


def plain_transmittance(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                        sigma_activation: str = "relu") -> torch.Tensor:
    """T [N, S] as ``integrate_plain`` forms it: exp of the exclusive cumsum
    of the log terms. Its weights are zero exactly where T < ert."""
    return _exclusive_exp(sample_terms(raw, z_vals, rays_d, sigma_activation)[1])


def past_the_cut(trans: torch.Tensor, ert: float):
    """(beyond, near) [N, S] masks for a check of ERT's zeros against the
    plain transmittance ``trans``: a kernel that sums the same S float32 log
    terms in another order forms log T within S 2^-24 sum|terms| of it, and
    sum|terms| = |log T| for terms <= 0, so its T may fall on the other side
    of ert only where |T - ert| <= ert (e^m - 1), m = S 2^-23 |log ert|
    ("near"). ``beyond``: T below ert outside that band, where every weight
    must be exactly 0."""
    m = trans.shape[-1] * 2.0 ** -23 * abs(math.log(ert))
    near = (trans - ert).abs() <= ert * math.expm1(m)
    return (trans < ert) & ~near, near


def integrate_plain(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                    ert_threshold: float = 0.0, white_bkgd: bool = True,
                    sigma_activation: str = "relu") -> Dict[str, torch.Tensor]:
    """raw [N, S, 4], z_vals [N, S], rays_d [N, 3] -> rgb_map, depth_map,
    acc_map, disp_map, weights. ``ert_threshold <= 0`` turns ERT off."""
    alpha, log_1ma = sample_terms(raw, z_vals, rays_d, sigma_activation)
    trans = _exclusive_exp(log_1ma)
    weights = alpha * trans
    if ert_threshold > 0:
        weights = weights * (trans >= ert_threshold).to(weights.dtype)
    rgb_map = torch.sum(torch.sigmoid(raw[..., :3]) * weights[..., None], dim=-2)
    out = finish_maps(rgb_map, torch.sum(weights * z_vals, -1), torch.sum(weights, -1),
                      white_bkgd)
    out["weights"] = weights
    return out


def lane_samples(S: int, up_front: bool = True):
    """How the kernel spreads a ray of S samples over a warp's 32 lanes:
    (K, chunk), lane l of each chunk of 32 K samples owning its samples
    c0 + l K .. c0 + l K + K - 1: whole rays of up to 256 samples at once,
    longer ones (or with ``up_front=False``, the kernel's variant) in chunks
    of 64."""
    k = -(-S // 32) if up_front and S <= 32 * _MAX_K else _CHUNK_K
    return k, 32 * k


def lane_transmittance(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                       sigma_activation: str = "relu", up_front: bool = True) -> torch.Tensor:
    """T [N, S] summed in the kernel's order (for the tests): each lane's log
    terms serially, an inclusive warp scan of the lane sums in 5 shuffle
    steps, the exclusive prefix from the lane before, a carry between chunks."""
    log_1ma = sample_terms(raw, z_vals, rays_d, sigma_activation)[1]
    n, s = log_1ma.shape
    k, ch = lane_samples(s, up_front)
    chunks = -(-s // ch)
    terms = torch.nn.functional.pad(log_1ma, (0, chunks * ch - s)).reshape(n, chunks, 32, k)
    log_t = torch.empty_like(terms)
    carry = torch.zeros((n,), dtype=terms.dtype, device=terms.device)
    for c in range(chunks):
        lane_sum = terms[:, c, :, 0]
        for j in range(1, k):
            lane_sum = lane_sum + terms[:, c, :, j]
        incl = lane_sum
        for off in (1, 2, 4, 8, 16):
            incl = incl + torch.nn.functional.pad(incl, (off, 0))[:, :32]
        excl = torch.nn.functional.pad(incl, (1, 0))[:, :32]
        acc = carry[:, None] + excl
        for j in range(k):
            log_t[:, c, :, j] = acc
            acc = acc + terms[:, c, :, j]
        carry = carry + incl[:, 31]
    return torch.exp(log_t.reshape(n, chunks * ch)[:, :s])


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
    cut = None
    if profiling.enabled():
        cut = _ert_cut_buffer(raw.device)
        profiling.count("b3.samples", z_vals.numel())
    out = _launch(_lib().launch_integrate, raw, z_vals, rays_d, ert_threshold, white_bkgd,
                  sigma_activation, (None if cut is None else cut.data_ptr(),))
    integrate.launches += 1
    return out


integrate.launches = 0

_ert_cut: Dict[torch.device, torch.Tensor] = {}  # int64 [], one a device


def _ert_cut_buffer(device: torch.device) -> torch.Tensor:
    buf = _ert_cut.get(device)
    if buf is None:
        buf = _ert_cut[device] = torch.zeros((), dtype=torch.int64, device=device)
    return buf


def ert_cut_count():
    """The samples whose weight ERT zeroed in ``integrate``'s launches while
    spans were on, summed over the devices (synchronises); None before the
    first such launch."""
    if not _ert_cut:
        return None
    return sum(int(buf.item()) for buf in _ert_cut.values())


def ert_cut_reset() -> None:
    for buf in _ert_cut.values():
        buf.zero_()


def integrate_warp(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                   ert_threshold: float = 0.0, white_bkgd: bool = True,
                   sigma_activation: str = "relu") -> Dict[str, torch.Tensor]:
    """The previous compositing kernel (32 samples a round,
    ``launch_integrate_warp``), CUDA tensors only. No path of the port calls
    it: it is the yardstick that the GPU tests and ``chip_smoke.py`` hold
    ``integrate`` against."""
    return _launch(_lib().launch_integrate_warp, raw, z_vals, rays_d, ert_threshold, white_bkgd,
                   sigma_activation)


def _launch(fn, raw, z_vals, rays_d, ert_threshold, white_bkgd, sigma_activation, extra=()):
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
    rc = fn(raw.data_ptr(), z_vals.data_ptr(), rays_d.data_ptr(), rgb_map.data_ptr(),
            depth.data_ptr(), acc.data_ptr(), weights.data_ptr(), N, S,
            float(ert_threshold), _ACTIVATIONS.index(sigma_activation), *extra,
            torch.cuda.current_stream(raw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"integrate kernel launch failed: CUDA error {rc}")
    out = finish_maps(rgb_map, depth, acc, white_bkgd)
    out["weights"] = weights
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("integrate"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built ``csrc/integrate.cu``'s exports."""
    p = ctypes.c_void_p
    args = [p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
    lib.launch_integrate.argtypes = args + [p, p]  # ..., ERT's counter (or null), stream
    lib.launch_integrate_warp.argtypes = args + [p]
    for fn in (lib.launch_integrate, lib.launch_integrate_warp):
        fn.restype = ctypes.c_int
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
