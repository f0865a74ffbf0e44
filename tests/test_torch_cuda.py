"""nerf_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor nerf_tpu, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances (as chip_smoke.py states them):
- fused MLP, bf16, against the plain version and against the previous
  (wmma) kernel: |k - p| / (1 + |p|) <= 5e-2 per element (at the sizes
  that end the persistent grid's rounds raggedly, <= max(5e-2, 2x the
  plain version summed in float64), as chip_smoke.py bounds it), its 99th
  percentile <= 1e-3 over at least 4096 points and its 99.9th <= 1e-2 over
  at least 65,536 (bf16 roundings that flip between two sum orders touch
  ~1% of the outputs, so over a few hundred outputs the 99th percentile is
  one of them); a point's output alone and inside a larger launch: exact;
  one layer's product through the kernel's wgmma path against
  torch.matmul in float32: within 2^-14 sum |a w| per element;
- integrate, float32: atol 2e-5 (sums of up to 192 terms in another order),
  against the plain version and against the previous (warp-round) kernel;
  a weight is exactly 0 wherever the plain version's transmittance is
  below the ERT threshold beyond the band its float32 sums' order can move
  it across (``integrate.past_the_cut``); a ray alone and inside a larger
  launch: exact;
- a rendered image: PSNR >= 40 dB against the plain path;
- fused backward (B2), bf16: every gradient leaf, dpts and ddirs within
  1e-2 in relative norm of the plain version, of the plain backward run
  on the kernel's own recomputed forward (each layer's gradient is rounded
  to bf16, 2^-9 relative, before its products; random points and upstream
  gradients spread the gradient over every point) and of the wmma
  backward; its recomputed forward, two launches, its mask bits and a
  prefix's input gradients inside a larger launch: exact; one weight-gradient
  product against torch.matmul in float32: within 2^-14 sum |x g|;
- hash-table row gather (B4): exact; its scatter-add: per element within
  ``hash_gather.scatter_add_tolerance`` of the plain version (two float32
  sums of the same terms in other orders, each rounded once to bf16; the
  kernel's atomics make its order change from run to run), and of the
  previous (one atomic per element) kernel, on index mixes that put runs of
  equal indices across warp edges;
- the hash-grid model (random tables): encodings and a render through the
  gather kernel against its plain gather exact (the same rows, the same
  float32 arithmetic after them); one hash-grid train step through the kernels against
  the plain versions: loss within 1e-4 relative, every gradient within 1e-2
  in relative norm (the tables' gradients differ by the scatter-add's
  bf16 rounding, 2^-8, and the MLP's by B3's float32 sums);
- one train step through the kernels against the plain versions: loss
  within 1e-4 relative; each parameter's gradient within max(1e-2, 2x the
  distance between the plain path and the plain path with float32 weights)
  in relative norm. The kernel's forward sums in another order than the
  plain one, so a ReLU mask can flip between them, and where a few points
  carry the gradient (292 of 16,384 coarse samples here) one flip moved a
  leaf by 11% on this test's first run; bf16's own distance from float32
  bounds flips of that kind.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.ops import fused_mlp, fused_mlp_bwd, hash_gather
from nerf_tpu_torch.ops import integrate as tint
from nerf_tpu_torch.render.renderer import RenderOptions, kernel_params, render_rays
from nerf_tpu_torch.serve import RenderService, look_at_pose
from nerf_tpu_torch.render.rays import image_rays
from nerf_tpu_torch.tools import scatter_variants
from nerf_tpu_torch.train.checkpoint import load_checkpoint, load_params

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


# ragged tiles of 64 and 128 points; 65,553 and 84,525 points end on ragged
# tiles after one and several rounds of the persistent grid (132 x 128 points)
FUSED_SIZES = [1, 63, 64, 127, 128, 129, 4099, 65536, 65553, 84525]


def _fused_rel(got, want):
    return ((got - want).abs() / (1.0 + want.abs())).flatten().cpu().numpy()


def _assert_fused_close(got, want, max_rel=5e-2):
    rel = _fused_rel(got, want)
    assert rel.max() <= max_rel, rel.max()
    if rel.size >= 4 * 4096:  # a percentile says something only over many elements
        assert np.percentile(rel, 99) <= 1e-3
    if rel.size >= 4 * 65536:
        assert np.percentile(rel, 99.9) <= 1e-2


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
    _assert_fused_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [127, 128, 129, 65553, 84525])
def test_fused_kernel_matches_plain_on_persistent_tiles(lego, cuda, n):
    """As above at the sizes that end the 128-point tiles and the persistent
    grid's rounds raggedly. The largest error is held, as chip_smoke.py holds
    it, to max(5e-2, 2x that of the plain version summed in float64): more
    points reach further into the tail of bf16 rounding flips (0.056 at
    84,525 random points, where 65,536 stayed below 5e-2)."""
    kp = {k: v.to(cuda) for k, v in fused_mlp.repack_params(lego["coarse"]).items()}
    pts, d = _points(n, n, cuda)
    got = fused_mlp.fused_nerf_eval(kp, pts, d)
    want = fused_mlp.fused_nerf_eval_plain(kp, pts, d)
    want64 = fused_mlp.fused_nerf_eval_plain(kp, pts, d, torch.float64)
    torch.cuda.synchronize()
    _assert_fused_close(got, want, max(5e-2, 2.0 * float(_fused_rel(want64, want).max())))


@pytest.mark.cuda
@pytest.mark.parametrize("n", FUSED_SIZES)
def test_fused_kernel_matches_the_wmma_kernel(lego, cuda, n):
    """The wgmma forward against the previous (wmma) forward kernel."""
    kp = {k: v.to(cuda) for k, v in fused_mlp.repack_params(lego["coarse"]).items()}
    pts, d = _points(n, n + 1, cuda)
    got = fused_mlp.fused_nerf_eval(kp, pts, d)
    want = fused_mlp.fused_nerf_eval_wmma(kp, pts, d)
    torch.cuda.synchronize()
    _assert_fused_close(got, want)


@pytest.mark.cuda
def test_fused_kernel_rows_do_not_depend_on_the_launch(lego, cuda):
    """A point's output is the same bits whatever its tile, its block and the
    points around it: the first n points alone against the same points at
    the head of a launch of 84,525 (the ragged tiles mask only what lies past P)."""
    kp = {k: v.to(cuda) for k, v in fused_mlp.repack_params(lego["coarse"]).items()}
    pts, d = _points(84525, 5, cuda)
    full = fused_mlp.fused_nerf_eval(kp, pts, d)
    for n in FUSED_SIZES[:-1]:
        part = fused_mlp.fused_nerf_eval(kp, pts[:n].contiguous(), d[:n].contiguous())
        assert torch.equal(part, full[:n]), n
    assert bool(torch.isfinite(full).all())


@pytest.mark.cuda
def test_wgmma_layer_product_matches_matmul(cuda):
    """One 128 x 256 x 256 product through the forward kernel's ring,
    descriptors and wgmma against torch.matmul of the same bf16 operands in
    float32: float32 sums of 256 terms in any order lie within
    256 * 2^-24 * sum |a w| of each other (2^-14 of it leaves 4x)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.normal(size=(128, 256)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32)).to(cuda)
    a, w = a.to(torch.bfloat16), w.to(torch.bfloat16)
    got = fused_mlp.wgmma_layer_product(a, w)
    want = a.float() @ w.float()
    scale = a.float().abs() @ w.float().abs()
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 2.0 ** -14 * scale).all())


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


# (N, S): a lone ray, S not a multiple of 32, the hash-grid tiles and train
# batches (1024 rays), a lego tile (8192), and rays longer than 256 samples
# (the kernel's chunked loop)
INTEGRATE_SHAPES = [(1, 37), (1000, 64), (333, 192), (1024, 64), (1024, 192), (8192, 192),
                    (77, 100), (5, 257), (64, 300), (3, 1000)]


def _integrate_inputs(n, s, cuda):
    rng = np.random.default_rng(n * 1000 + s)
    raw = rng.normal(size=(n, s, 4)).astype(np.float32)
    raw[..., 3] *= 20.0
    z = np.sort(rng.uniform(2, 6, (n, s)).astype(np.float32), axis=-1)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(cuda) for a in (raw, z, d))


@pytest.mark.cuda
@pytest.mark.parametrize("ert", [0.0, 0.01])
@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("n,s", INTEGRATE_SHAPES)
def test_integrate_kernel_matches_plain_and_the_warp_kernel(cuda, ert, act, n, s):
    raw, z, d = _integrate_inputs(n, s, cuda)
    got = tint.integrate(raw, z, d, ert, True, act)
    want = tint.integrate_plain(raw, z, d, ert, True, act)
    old = tint.integrate_warp(raw, z, d, ert, True, act)
    torch.cuda.synchronize()
    for k in ("rgb_map", "depth_map", "acc_map", "weights"):
        torch.testing.assert_close(got[k], want[k], atol=2e-5, rtol=0, msg=k)
        torch.testing.assert_close(got[k], old[k], atol=2e-5, rtol=0, msg=k)
    if ert > 0:
        beyond, _ = tint.past_the_cut(tint.plain_transmittance(raw, z, d, act), ert)
        assert bool((got["weights"][beyond] == 0).all())


@pytest.mark.cuda
def test_integrate_kernel_is_rowwise(cuda):
    raw, z, d = _integrate_inputs(8192, 192, cuda)
    whole = tint.integrate(raw, z, d, 0.01, True, "relu")
    for n in (1, 33, 1000, 1024):
        part = tint.integrate(raw[:n].contiguous(), z[:n].contiguous(), d[:n].contiguous(),
                              0.01, True, "relu")
        for k in ("rgb_map", "depth_map", "acc_map", "weights"):
            assert torch.equal(part[k], whole[k][:n]), (n, k)


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


def _rel_norm(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 1000, 65536])  # ragged tiles of 64 points
def test_fused_backward_matches_plain(lego, cuda, n):
    kp = {k: v.to(cuda) for k, v in fused_mlp.repack_params(lego["fine"]).items()}
    pts, d = _points(n, n + 1, cuda)
    g = torch.from_numpy(np.random.default_rng(n).normal(size=(n, 4)).astype(np.float32)).to(cuda)
    before = fused_mlp_bwd.fused_nerf_bwd.launches
    got = fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g)
    want = fused_mlp_bwd.fused_nerf_bwd_plain(kp, pts, d, g)
    torch.cuda.synchronize()
    assert fused_mlp_bwd.fused_nerf_bwd.launches == before + 1
    for k in fused_mlp_bwd._GRAD_KEYS:
        assert got[0][k].shape == want[0][k].shape, k
        assert _rel_norm(got[0][k], want[0][k]) <= 1e-2, k
    assert got[1].shape == (n, 3) and got[2].shape == (n, 3)
    assert _rel_norm(got[1], want[1]) <= 1e-2 and _rel_norm(got[2], want[2]) <= 1e-2
    no_inputs = fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g, input_grads=False)
    assert no_inputs[1] is None and no_inputs[2] is None
    for k in fused_mlp_bwd._GRAD_KEYS:  # the same launches, without the input gradients
        torch.testing.assert_close(no_inputs[0][k], got[0][k], rtol=0, atol=0, msg=k)
    kgrads, dpts, ddirs, stash = fused_mlp_bwd.launch(kp, pts, d, g)
    acts = fused_mlp_bwd.stash_activations(kp, stash, pts, d)
    own = fused_mlp_bwd.backward_from_activations(kp, acts, g)
    for k in fused_mlp_bwd._GRAD_KEYS:
        assert _rel_norm(kgrads[k], own[0][k]) <= 1e-2, k
    assert _rel_norm(dpts, own[1]) <= 1e-2 and _rel_norm(ddirs, own[2]) <= 1e-2


# ragged 64- and 128-point tiles, one round of the persistent grid and a
# ragged end, and the lego step's fine batch
BWD_SIZES = [1, 63, 64, 127, 128, 129, 65553, 196608]


def _bwd_inputs(lego, cuda, n, seed=0):
    kp = {k: v.to(cuda) for k, v in fused_mlp.repack_params(lego["fine"]).items()}
    pts, d = _points(n, n + seed, cuda)
    g = torch.from_numpy(np.random.default_rng(n + seed).normal(size=(n, 4))
                         .astype(np.float32)).to(cuda)
    return kp, pts, d, g


@pytest.mark.cuda
@pytest.mark.parametrize("n", BWD_SIZES)
def test_wgmma_backward_matches_plain_on_its_stash(lego, cuda, n):
    """The redesigned backward against the plain backward run on its own
    stash (the same bf16 activations and masks): every leaf, dpts and ddirs
    within 1e-2 in relative norm; its recomputed raw is launch_fused_nerf's
    output bit for bit (the same kernel code); its mask bits are those of its
    stash."""
    kp, pts, d, g = _bwd_inputs(lego, cuda, n)
    out = fused_mlp_bwd.launch_full(kp, pts, d, g)
    raw = fused_mlp.fused_nerf_eval(kp, pts, d)
    acts = fused_mlp_bwd.stash_activations(kp, out["stash"], pts, d)
    own = fused_mlp_bwd.backward_from_activations(kp, acts, g)
    torch.cuda.synchronize()
    assert torch.equal(out["raw"], raw)
    for k in fused_mlp_bwd._GRAD_KEYS:
        assert _rel_norm(out["kgrads"][k], own[0][k]) <= 1e-2, k
    assert out["dpts"].shape == (n, 3) and out["ddirs"].shape == (n, 3)
    assert _rel_norm(out["dpts"], own[1]) <= 1e-2 and _rel_norm(out["ddirs"], own[2]) <= 1e-2
    m = out["masks"].shape[0] * 64
    padded = fused_mlp_bwd.stash_activations(
        kp, fused_mlp_bwd.unpack_slabs(out["stash_slabs"], m), torch.zeros((m, 3), device=cuda),
        torch.zeros((m, 3), device=cuda))
    assert torch.equal(fused_mlp_bwd.mask_bits(padded), out["masks"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 65553])
def test_wgmma_backward_matches_the_wmma_backward(lego, cuda, n):
    """The redesigned backward against the wmma one: every leaf, dpts and
    ddirs within 1e-2 in relative norm (the two forwards sum in other orders,
    so a ReLU mask or a bf16 rounding can flip between them)."""
    kp, pts, d, g = _bwd_inputs(lego, cuda, n, 1)
    got = fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g)
    want = fused_mlp_bwd.fused_nerf_bwd_wmma(kp, pts, d, g)
    torch.cuda.synchronize()
    for k in fused_mlp_bwd._GRAD_KEYS:
        assert _rel_norm(got[0][k], want["kgrads"][k]) <= 1e-2, k
    assert _rel_norm(got[1], want["dpts"]) <= 1e-2 and _rel_norm(got[2], want["ddirs"]) <= 1e-2


@pytest.mark.cuda
def test_wgmma_backward_is_deterministic_and_rowwise(lego, cuda):
    """Two launches give the same bits (the weight gradients sum their
    ranges in a fixed order); the dpts and ddirs of a prefix launched alone
    are the same rows of a larger launch (a point's chain does not depend
    on its tile or its neighbours)."""
    kp, pts, d, g = _bwd_inputs(lego, cuda, 84525, 2)
    a = fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g)
    b = fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g)
    torch.cuda.synchronize()
    for k in fused_mlp_bwd._GRAD_KEYS:
        assert torch.equal(a[0][k], b[0][k]), k
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    for n in (1, 63, 64, 127, 128, 129, 65553):
        part = fused_mlp_bwd.fused_nerf_bwd(kp, pts[:n].contiguous(), d[:n].contiguous(),
                                            g[:n].contiguous())
        assert torch.equal(part[1], a[1][:n]) and torch.equal(part[2], a[2][:n]), n


@pytest.mark.cuda
def test_wgrad_product_matches_matmul(cuda):
    """One 64 x 256 weight-gradient product over 64 points through the dW
    kernel's slab layout, MN-major descriptors and wgmma against
    torch.matmul in float32: float32 sums of 64 terms in any order lie within
    64 * 2^-24 * sum |x g| of each other (2^-14 of it leaves 4x)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)).to(cuda).to(torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32)).to(cuda).to(torch.bfloat16)
    got = fused_mlp_bwd.wgrad_product(x, g)
    want = x.float().T @ g.float()
    scale = x.float().abs().T @ g.float().abs()
    assert bool(((got - want).abs() <= 2.0 ** -14 * scale).all())


@pytest.mark.cuda
def test_fused_backward_rejects_what_it_cannot_take(lego, cuda):
    kp = fused_mlp.repack_params(lego["coarse"])
    pts, d = _points(8, 0, cuda)
    g = torch.zeros((8, 4), device=cuda)
    with pytest.raises(ValueError, match="wbuf"):  # weights left on the CPU
        fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g)
    kp = {k: v.to(cuda) for k, v in kp.items()}
    with pytest.raises(ValueError, match="^g:"):
        fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g.double())
    with pytest.raises(ValueError, match="^g:"):
        fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g[:, :3].contiguous())
    with pytest.raises(ValueError, match="^dirs:"):
        fused_mlp_bwd.fused_nerf_bwd(kp, pts, d.cpu(), g)


@pytest.mark.cuda
def test_train_step_kernels_match_plain(cuda, tmp_path):
    from nerf_tpu_torch.render.renderer import RenderOptions as RO
    from nerf_tpu_torch.train import loop
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import init_state, loss_and_grads, sample_ray_batch

    cfg = make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"), ["occupancy_grid_resolution", "32"])
    opts = RO.from_cfg(cfg)
    template = init_state(loop.init_nerf_params(torch.Generator().manual_seed(0), opts, cuda),
                          make_optimizer(cfg))
    state, epoch, _ = load_checkpoint(LEGO, template)
    assert epoch == 49 and state.step == 12500
    gen = torch.Generator(device=cuda).manual_seed(0)
    imgs = torch.randint(0, 256, (2, 32, 32, 3), generator=gen, device=cuda, dtype=torch.uint8)
    poses = torch.as_tensor(np.stack([look_at_pose(t, 0.3, 4.0) for t in (0.5, 2.0)]),
                            device=cuda)
    K = torch.tensor([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], device=cuda)
    ro, rd, tgt = sample_ray_batch(gen, imgs, poses, K, 256)
    rng = gen.get_state()
    before = (fused_mlp.fused_nerf_eval.launches, fused_mlp_bwd.fused_nerf_bwd.launches,
              tint.integrate.launches)
    lk, _, gk = loss_and_grads(state.params, ro, rd, tgt, opts, None, gen)
    after = (fused_mlp.fused_nerf_eval.launches, fused_mlp_bwd.fused_nerf_bwd.launches,
             tint.integrate.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    gen.set_state(rng)
    lp, _, gp = loss_and_grads(state.params, ro, rd, tgt, plain, None, gen)
    gen.set_state(rng)
    _, _, g32 = loss_and_grads(state.params, ro, rd, tgt,
                               dataclasses.replace(plain, compute_dtype="float32"), None, gen)
    assert abs(float(lk) - float(lp)) <= 1e-4 * abs(float(lp))
    for i, (a, b, c) in enumerate(zip(gk, gp, g32)):
        assert _rel_norm(a, b) <= max(1e-2, 2.0 * _rel_norm(b, c)), i


def _hash_rows(cuda, n_rows, width, dtype, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    table = (torch.rand((n_rows, width), generator=gen, device=cuda) * 2 - 1).to(dtype)
    # a few hot rows take half the indices, as the coarse levels do
    hot = torch.randint(0, min(n_rows, 64), (n // 2,), generator=gen, device=cuda)
    cold = torch.randint(0, n_rows, (n - n // 2,), generator=gen, device=cuda)
    idx = torch.cat([hot, cold])[torch.randperm(n, generator=gen, device=cuda)]
    return table, idx.to(torch.int32).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,width,dtype", [
    (16 * 65536, 16, torch.bfloat16),  # cellpack rows, 32 B
    (16 * 2**19, 2, torch.bfloat16),  # corner rows, 4 B
    (4096, 2, torch.float32),  # 8 B
    (1000, 3, torch.float32),  # 12 B: 4-byte words
    (77, 1, torch.bfloat16)])  # 2 B
@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
def test_gather_kernel_matches_plain(cuda, n_rows, width, dtype, n):
    table, idx = _hash_rows(cuda, n_rows, width, dtype, n, n)
    before = hash_gather.gather_rows.launches
    got = hash_gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert hash_gather.gather_rows.launches == before + 1
    assert torch.equal(got, hash_gather.gather_rows_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", [(16, torch.bfloat16), (2, torch.float32),
                                         (3, torch.bfloat16)])
def test_scatter_add_kernel_matches_plain(cuda, width, dtype):
    n_rows, n = 4096, 1 << 20
    _, idx = _hash_rows(cuda, n_rows, width, dtype, n, 7)
    gen = torch.Generator(device=cuda).manual_seed(8)
    cot = torch.randn((n, width), generator=gen, device=cuda).to(dtype)
    before = hash_gather.scatter_add_rows.launches
    got = hash_gather.scatter_add_rows(idx, cot, n_rows)
    want = hash_gather.scatter_add_rows_plain(idx, cot, n_rows)
    torch.cuda.synchronize()
    assert hash_gather.scatter_add_rows.launches == before + 1
    assert got.dtype == dtype and got.shape == (n_rows, width)
    tol = hash_gather.scatter_add_tolerance(idx, cot, want)
    assert bool(((got.double() - want.double()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,width,dtype", [
    (16 * 65536, 16, torch.bfloat16),  # cellpack rows
    (16 * 2**19, 2, torch.bfloat16),  # corner rows
    (4096, 2, torch.float32),
    (4096, 3, torch.bfloat16)])
@pytest.mark.parametrize("mix", scatter_variants.MIXES)
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 1 << 20, 3_145_728])
def test_scatter_add_kernel_on_index_mixes(cuda, n_rows, width, dtype, mix, n):
    gen = torch.Generator(device=cuda).manual_seed(n + width)
    idx = scatter_variants.index_mix(mix, n, n_rows, gen)
    cot = torch.randn((n, width), generator=gen, device=cuda).to(dtype)
    got = hash_gather.scatter_add_rows(idx, cot, n_rows)
    want = hash_gather.scatter_add_rows_plain(idx, cot, n_rows)
    old = hash_gather.scatter_add_rows_atomic(idx, cot, n_rows)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n_rows, width)
    for ref in (want, old):
        tol = hash_gather.scatter_add_tolerance(idx, cot, ref)
        assert bool(((got.double() - ref.double()).abs() <= tol).all())


@pytest.mark.cuda
def test_gather_kernels_reject_what_they_cannot_take(cuda):
    table, idx = _hash_rows(cuda, 100, 16, torch.bfloat16, 10, 0)
    with pytest.raises(ValueError, match="^idx:"):
        hash_gather.gather_rows(table, idx.long())
    with pytest.raises(ValueError, match="dtype"):
        hash_gather.gather_rows(table.half(), idx)
    with pytest.raises(ValueError, match="^cot:"):
        hash_gather.scatter_add_rows(idx, torch.zeros((10, 16), device=cuda)[:, ::2], 100)


def _hash_setup(cuda, n_rays=256):
    from nerf_tpu_torch.train import loop

    cfg = make_cfg(os.path.join(ROOT, "configs/nerf/lego_hashgrid_cellpack.yaml"),
                   ["task_arg.perturb", "0"])
    opts = RenderOptions.from_cfg(cfg)
    params = loop.init_nerf_params(torch.Generator().manual_seed(0), opts, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():  # trained-looking tables: features of order 1
        for m in params.values():
            m["xyz_encoder"]["table"].uniform_(-1, 1, generator=gen)
    pose = torch.as_tensor(look_at_pose(0.5, 0.3, 4.0), device=cuda)
    K = torch.tensor([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], device=cuda)
    ro, rd = image_rays(32, 32, K, pose)
    return cfg, opts, params, ro[:n_rays].contiguous(), rd[:n_rays].contiguous()


@pytest.mark.cuda
def test_hash_render_through_the_gather_kernel_matches_plain(cuda):
    from nerf_tpu_torch.models.hashgrid import hashgrid_encode

    _, opts, params, ro, rd = _hash_setup(cuda)
    pts = (torch.rand((5000, 3), device=cuda) * 4 - 2)
    for layout_params in (params["coarse"]["xyz_encoder"],):
        a = hashgrid_encode(layout_params, pts, layout="cellpack")
        b = hashgrid_encode(layout_params, pts, layout="cellpack", plain=True)
        assert torch.equal(a, b)
    before = hash_gather.gather_rows.launches
    kp = kernel_params(params, opts, cuda)
    got = render_rays(kp, ro, rd, opts)
    assert hash_gather.gather_rows.launches == before + 2
    want = render_rays(kp, ro, rd, dataclasses.replace(opts, use_fused_mlp=False))
    for k in ("rgb_map", "acc_map", "rgb_map_0", "depth_map"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_hash_train_step_kernels_match_plain(cuda):
    from nerf_tpu_torch.train.state import loss_and_grads

    _, opts, params, ro, rd = _hash_setup(cuda)
    tgt = torch.rand((ro.shape[0], 3), generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    rng = gen.get_state()
    counters = (hash_gather.gather_rows, hash_gather.scatter_add_rows, tint.integrate)
    before = [c.launches for c in counters]
    lk, _, gk = loss_and_grads(params, ro, rd, tgt, opts, None, gen)
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2]
    gen.set_state(rng)
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    lp, _, gp = loss_and_grads(params, ro, rd, tgt, plain, None, gen)
    assert abs(float(lk) - float(lp)) <= 1e-4 * abs(float(lp))
    for i, (a, b) in enumerate(zip(gk, gp)):
        assert a.dtype == b.dtype and _rel_norm(a, b) <= 1e-2, i
