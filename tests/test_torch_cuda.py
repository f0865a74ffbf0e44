"""nerf_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor nerf_tpu, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances (as chip_smoke.py states them):
- fused MLP, bf16: |k - p| / (1 + |p|) <= 5e-2 per element, and its 99th
  percentile <= 1e-3 over at least 4096 points (bf16 roundings that flip
  between two sum orders touch ~1% of the outputs, so over a few hundred
  outputs the 99th percentile is one of them);
- integrate, float32: atol 2e-5 (sums of up to 192 terms in another order);
- a rendered image: PSNR >= 40 dB against the plain path.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.ops import fused_mlp
from nerf_tpu_torch.ops import integrate as tint
from nerf_tpu_torch.render.renderer import RenderOptions, kernel_params, render_rays
from nerf_tpu_torch.serve import RenderService, look_at_pose
from nerf_tpu_torch.render.rays import image_rays
from nerf_tpu_torch.train.checkpoint import load_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def lego():
    return load_params(LEGO)


def _points(n, seed, dev):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(pts).to(dev), torch.from_numpy(d).to(dev)


def _psnr(a, b):
    return -10.0 * math.log10(max(float(torch.mean((a - b) ** 2)), 1e-20))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 4099, 65536])  # ragged tiles of 64 points
def test_fused_kernel_matches_plain(lego, cuda, n):
    kp = {k: v.to(cuda) for k, v in fused_mlp.repack_params(lego["coarse"]).items()}
    pts, d = _points(n, n, cuda)
    before = fused_mlp.fused_nerf_eval.launches
    got = fused_mlp.fused_nerf_eval(kp, pts, d)
    want = fused_mlp.fused_nerf_eval_plain(kp, pts, d)
    torch.cuda.synchronize()
    assert fused_mlp.fused_nerf_eval.launches == before + 1
    rel = ((got - want).abs() / (1.0 + want.abs())).flatten().cpu().numpy()
    assert rel.max() <= 5e-2
    if rel.size >= 4 * 4096:  # a percentile says something only over many elements
        assert np.percentile(rel, 99) <= 1e-3


@pytest.mark.cuda
def test_fused_kernel_rejects_what_it_cannot_take(lego, cuda):
    kp = fused_mlp.repack_params(lego["coarse"])
    pts, d = _points(8, 0, cuda)
    with pytest.raises(ValueError, match="wbuf"):  # weights left on the CPU
        fused_mlp.fused_nerf_eval(kp, pts, d)
    kp32 = {k: v.to(cuda) for k, v in
            fused_mlp.repack_params(lego["coarse"], weight_dtype=torch.float32).items()}
    with pytest.raises(ValueError, match="wbuf"):  # the kernel reads bf16 only
        fused_mlp.fused_nerf_eval(kp32, pts, d)
    kp = {k: v.to(cuda) for k, v in kp.items()}
    with pytest.raises(ValueError, match="pts"):
        fused_mlp.fused_nerf_eval(kp, pts.double(), d)


@pytest.mark.cuda
@pytest.mark.parametrize("ert", [0.0, 0.01])
@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("n,s", [(1, 37), (1000, 64), (333, 192)])
def test_integrate_kernel_matches_plain(cuda, ert, act, n, s):
    rng = np.random.default_rng(n + s)
    raw = rng.normal(size=(n, s, 4)).astype(np.float32)
    raw[..., 3] *= 20.0
    z = np.sort(rng.uniform(2, 6, (n, s)).astype(np.float32), axis=-1)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    raw, z, d = (torch.from_numpy(a).to(cuda) for a in (raw, z, d))
    before = tint.integrate.launches
    got = tint.integrate(raw, z, d, ert, True, act)
    want = tint.integrate_plain(raw, z, d, ert, True, act)
    torch.cuda.synchronize()
    assert tint.integrate.launches == before + 1
    for k in ("rgb_map", "depth_map", "acc_map", "weights"):
        torch.testing.assert_close(got[k], want[k], atol=2e-5, rtol=0, msg=k)


@pytest.mark.cuda
def test_integrate_kernel_rejects_a_misaligned_raw(cuda):
    raw = torch.zeros(4 * 8 * 4 + 1, device=cuda)[1:].reshape(4, 8, 4)
    with pytest.raises(ValueError, match="aligned"):
        tint.integrate(raw, torch.ones(4, 8, device=cuda), torch.ones(4, 3, device=cuda))


@pytest.mark.cuda
def test_render_rays_kernels_match_plain(lego, cuda):
    opts = RenderOptions(perturb=0.0, enable_ess=False)
    params = kernel_params(lego, opts, cuda)
    K = torch.tensor([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], device=cuda)
    o, d = image_rays(32, 32, K, torch.as_tensor(look_at_pose(0.5, 0.3, 4.0), device=cuda))
    got = render_rays(params, o.contiguous(), d.contiguous(), opts)
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    want = render_rays(params, o.contiguous(), d.contiguous(), plain)
    assert _psnr(got["rgb_map"], want["rgb_map"]) >= 40.0


@pytest.mark.cuda
def test_render_service_defaults_to_the_gpu(cuda):
    cfg = make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"),
                   ["trained_model_dir", LEGO, "occupancy_grid_resolution", "32"])
    before = (fused_mlp.fused_nerf_eval.launches, tint.integrate.launches)
    service = RenderService(cfg, size=32)
    rgb = service.render(0.5, 0.3, 4.0)
    assert rgb.device.type == "cuda" and rgb.shape == (32, 32, 3)
    assert bool(torch.isfinite(rgb).all())
    assert fused_mlp.fused_nerf_eval.launches > before[0]
    assert tint.integrate.launches > before[1]
