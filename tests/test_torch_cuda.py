"""nerf_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor nerf_tpu, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances (as chip_smoke.py states them):
- fused MLP, bf16, against the plain version: |k - p| / (1 + |p|) <= 5e-2
  per element (at the sizes that end the persistent grid's rounds raggedly,
  <= max(5e-2, 2x the plain version summed in float64), as chip_smoke.py
  bounds it), its 99th percentile <= 1e-3 over at least 4096 points and its
  99.9th <= 1e-2 over at least 65,536 (bf16 roundings that flip between two
  sum orders touch ~1% of the outputs, so over a few hundred outputs the
  99th percentile is one of them); a point's output alone and inside a
  larger launch: exact; one layer's product through the kernel's wgmma path
  against torch.matmul in float32: within 2^-14 sum |a w| per element;
- integrate, float32: atol 2e-5 (sums of up to 192 terms in another order),
  against the plain version; a weight is exactly 0 wherever the plain
  version's transmittance is below the ERT threshold beyond the band its
  float32 sums' order can move it across (``integrate.past_the_cut``); a ray
  alone and inside a larger launch: exact;
- a rendered image: PSNR >= 40 dB against the plain path;
- fused backward (B2), bf16: every gradient leaf, dpts and ddirs within 1e-2
  in relative norm of the plain version, of the plain backward run on the
  kernel's own recomputed forward (each layer's gradient is rounded to bf16,
  2^-9 relative, before its products; random points and upstream gradients
  spread the gradient over every point); its recomputed forward, two
  launches, its mask bits and a prefix's input gradients inside a larger
  launch: exact; one weight-gradient product against torch.matmul in
  float32: within 2^-14 sum |x g|;
- hash-table row gather (B4): exact against the plain version for rows of 2
  to 32 bytes (and 6, 12), bf16 and float32, at tails that are not whole
  vectors, on index views only 4-byte aligned and on heavy duplicates; an
  out-of-range index raises at the next synchronisation (in a process of its
  own: the trap ends the process's CUDA context); its scatter-add: per
  element within ``hash_gather.scatter_add_tolerance`` of the plain version
  (two float32 sums of the same terms in other orders, each rounded once to
  bf16; the kernel's atomics make its order change from run to run), also on
  index mixes that put runs of equal indices across warp edges;
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
  bounds flips of that kind;
- the float32 kernels (B1-f32, B2-f32), as chip_smoke.py and
  nerf_tpu_torch/tools/f32_check.py bound them: the forward's largest
  |k - p| / (1 + |p|) over every size checked within 2x that of the plain
  version summed in float32 against float64; the backward per leaf within
  2e-4 max|want| + 1e-6 (dpts, ddirs 1e-3 of their largest), the knife-edge
  points' cotangents zeroed on both sides (float64 margins); a prefix
  alone and inside a larger launch, and two launches: exact; a train step
  through them against the plain float32 path with the same fine samples
  and masking: loss within 1e-5 relative, every leaf as the backward; a
  bad unit table raises;
- the evaluation slice: B1 on compacted [cap, 1, 3] batches as on the
  persistent tiles (largest error within max(5e-2, 2x the float64 plain
  version's)); a marched block through the kernels at PSNR >= 40 dB from
  the plain path; the Blender loader's tensors copied to the card exactly.
- KiloNeRF (torch.bmm in full float32, no hand-written kernel): outputs of
  served points within 2e-5 (1 + |p64|) of the per-point evaluation in
  float64, dropped points exactly 0, whatever the process's TF32 setting
  (the result is the same bit for bit with TF32 allowed and not); with TF32
  allowed and no wrap, every gradient leaf within 1e-5 of its largest
  |value| of the float64 evaluation's, the caller's setting kept; a frame
  through B3 at PSNR >= 40 dB from B3's plain version; one distillation
  step on the card: the loss and every gradient leaf within 1e-4 of its
  largest |value| of the same step on the CPU (float32 sums in other orders).
- data and expert parallelism at world 1 over NCCL (a launched rank): the
  lego step (bf16 kernels) equal bit for bit to the step without a group;
  kilonerf_eval_ep equal bit for bit to kilonerf_eval; a KiloNeRF train step
  through B3 against B3's plain version: loss within 1e-4 relative, every
  gradient leaf within 1e-4 of its largest |value|.
- the encoder factory's hash-based types (corner tables of 2 bf16, D = 2,
  3 and 4): forward through B4 equal to the plain gather's (where a 3-D
  grid's points do not require grad, through the hash encoder's kernels:
  within twice the largest ``interp_tolerance`` of those calls, the same 8
  products summed in another order, which hash_coef's blend of its bases,
  with weights that sum to 1, rounds once more on each side); each table's
  gradient through B4' per element within ``scatter_add_tolerance`` of the
  plain version on the same cotangent rows (hash_coef's plain run's own
  within 1e-3 in relative norm: its coefficient grid's cotangent carries its
  bases' features, summed in another order where a grid is fused), and each
  ``hash_interp_bwd``'s rows equal to ``hash_interp_bwd_plain``'s on the
  same cotangent and points; every float32 leaf within
  1e-5 of its largest |value| (the same products; index_put's atomics may add
  the latent codes' rows in another order); B4 and B4' counted on the
  kernel path only. One img_fit step on the card against the same step on
  the CPU from the same state and pixels, with TF32 allowed in the process:
  loss within 1e-5 relative, every gradient leaf within 1e-5 of its largest
  |value| (its products run in full float32 whatever the setting).
- the tensor helpers (utils/ray_utils, utils/data_utils) on the card
  against the same functions on the CPU: get_near_far's hits equal, near
  and far within 1e-6; heatmap_nms, topk and gather_feat equal (values
  without ties); memory_stats reports the card's bytes; a trace of a
  render names B1's and B3's kernels.
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
from nerf_tpu_torch.data.blender import BlenderDataset, write_blender_scene
from nerf_tpu_torch.render import marched, occupancy
from nerf_tpu_torch.render import renderer as rend
from nerf_tpu_torch.render.renderer import (RenderOptions, kernel_params, make_density_fn,
                                            render_rays)
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
    kp16 = {k: v.to(cuda) for k, v in
            fused_mlp.repack_params(lego["coarse"], weight_dtype=torch.float16).items()}
    with pytest.raises(ValueError, match="wbuf"):  # the kernels read bf16 or float32 only
        fused_mlp.fused_nerf_eval(kp16, pts, d)
    kp = {k: v.to(cuda) for k, v in kp.items()}
    with pytest.raises(ValueError, match="pts"):
        fused_mlp.fused_nerf_eval(kp, pts.double(), d)


# (N, S): a lone ray, S not a multiple of 32, the hash-grid tiles and train
# batches (1024 rays), a lego tile (8192), and rays longer than 256 samples
# (the kernel's chunked loop)
INTEGRATE_SHAPES = [(1, 37), (1000, 64), (333, 192), (1024, 64), (1024, 192), (8192, 192),
                    (77, 100), (5, 257), (64, 300), (3, 1000)]


def _integrate_inputs(n, s, cuda, seed=None):
    rng = np.random.default_rng(n * 1000 + s if seed is None else seed)
    raw = rng.normal(size=(n, s, 4)).astype(np.float32)
    raw[..., 3] *= 20.0
    z = np.sort(rng.uniform(2, 6, (n, s)).astype(np.float32), axis=-1)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(cuda) for a in (raw, z, d))


@pytest.mark.cuda
@pytest.mark.parametrize("ert", [0.0, 0.01])
@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("n,s,seed", [(n, s, n + s) for n, s in ((1, 37), (1000, 64), (333, 192))]
                         + [(n, s, n * 1000 + s) for n, s in INTEGRATE_SHAPES])
def test_integrate_kernel_matches_plain(cuda, ert, act, n, s, seed):
    raw, z, d = _integrate_inputs(n, s, cuda, seed)
    before = tint.integrate.launches
    got = tint.integrate(raw, z, d, ert, True, act)
    want = tint.integrate_plain(raw, z, d, ert, True, act)
    torch.cuda.synchronize()
    assert tint.integrate.launches == before + 1
    for k in ("rgb_map", "depth_map", "acc_map", "weights"):
        torch.testing.assert_close(got[k], want[k], atol=2e-5, rtol=0, msg=k)
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


def _lego_tile(lego, cuda, n, s):
    """A lego tile: n rays through the middle rows of a 200x200 orbit view,
    s evenly spaced samples in [2, 6], raw from the fine MLP (B1)."""
    opts = RenderOptions(perturb=0.0, enable_ess=False)
    kp = kernel_params(lego, opts, cuda)["fine"]
    K = torch.tensor([[278.0, 0, 100], [0, 278.0, 100], [0, 0, 1]], device=cuda)
    o, d = image_rays(200, 200, K, torch.as_tensor(look_at_pose(0.5, 0.3, 4.0), device=cuda))
    first = 20_000 - n // 2
    o, d = o[first:first + n].contiguous(), d[first:first + n].contiguous()
    z = torch.linspace(2.0, 6.0, s, device=cuda).expand(n, s).contiguous()
    raw = fused_mlp.query_network(kp, o[:, None] + d[:, None] * z[..., None], d)
    return raw.reshape(n, s, 4).contiguous(), z, d


def _counted(raw, z, d, ert):
    """integrate under a profiler: (its maps, its count of samples past
    ERT's cut, the samples it was given)."""
    from torch.profiler import ProfilerActivity, profile

    from nerf_tpu_torch.utils import profiling

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = tint.integrate(raw, z, d, ert, True, "relu")
    counts = profiling.counters()
    profiling.reset()
    return got, counts["b3.ert_cut"], counts["b3.samples"]


@pytest.mark.cuda
@pytest.mark.parametrize("ert", [0.01, 0.1])
@pytest.mark.parametrize("n,s", [(8192, 64), (8192, 192), (77, 192), (1024, 300)])
def test_integrate_counts_the_samples_past_erts_cut(lego, cuda, ert, n, s):
    """On lego tiles (a partial last block at 77 rays, the chunked loop at
    300 samples) the count lies between the plain transmittance's samples
    surely past the cut and those past it or within rounding of it; the maps
    are those of the launch without a counter; with ERT off it is 0."""
    raw, z, d = _lego_tile(lego, cuda, n, s)
    beyond, near = tint.past_the_cut(tint.plain_transmittance(raw, z, d), ert)
    got, cut, samples = _counted(raw, z, d, ert)
    assert samples == n * s
    assert int(beyond.sum()) <= cut <= int((beyond | near).sum())
    assert int(beyond.sum()) > 0
    plain = tint.integrate(raw, z, d, ert, True, "relu")
    for k in ("rgb_map", "depth_map", "acc_map", "weights"):
        assert torch.equal(got[k], plain[k]), k
    assert _counted(raw, z, d, 0.0)[1] == 0


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
    (77, 1, torch.bfloat16),  # 2 B
    (4096, 4, torch.bfloat16),  # 8 B
    (4096, 8, torch.bfloat16),  # 16 B
    (4096, 1, torch.float32),  # 4 B
    (4096, 2, torch.float32),  # 8 B
    (4096, 4, torch.float32),  # 16 B
    (4096, 8, torch.float32),  # 32 B
    (1000, 3, torch.bfloat16),  # 6 B: 2-byte pieces
    (1000, 3, torch.float32)])  # 12 B: 4-byte pieces
@pytest.mark.parametrize("n", [1, 7, 1000, (1 << 20) + 3])  # the last: whole threads plus 3
@pytest.mark.parametrize("kind", ["contiguous", "view", "one_row"])
def test_gather_kernel_matches_plain(cuda, n_rows, width, dtype, n, kind):
    table, idx = _hash_rows(cuda, n_rows, width, dtype, n + 1, n)
    if kind == "view":  # a view 4 bytes into a larger tensor
        idx = idx[1:]
        assert idx.data_ptr() % 8 == 4 and idx.is_contiguous()
    else:
        idx = idx[:n].clone()
        if kind == "one_row":
            idx.fill_(n_rows - 1)
    before = hash_gather.gather_rows.launches
    got = hash_gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert hash_gather.gather_rows.launches == before + 1
    assert torch.equal(got, hash_gather.gather_rows_plain(table, idx))


_OUT_OF_RANGE = """
import sys, torch
sys.path.insert(0, {root!r})
from nerf_tpu_torch.ops import hash_gather
table = torch.zeros(({n_rows}, {width}), dtype=torch.bfloat16, device="cuda")
idx = torch.zeros({n}, dtype=torch.int32, device="cuda")
idx[{at}] = {bad}
fn = getattr(hash_gather, {fn!r})
try:
    fn(table, idx)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
"""


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["gather_rows"])
@pytest.mark.parametrize("width,n,at,bad", [
    (2, 100_000, 50_000, 4096),  # 4-byte rows, inside a whole vector
    (2, 100_003, 100_001, 4096),  # 4-byte rows, in the last short vector
    (2, 100_000, 7, -1),  # a negative index
    (16, 100_000, 99_999, 1 << 30)])  # 32-byte rows
def test_gather_kernel_raises_on_an_index_out_of_range(cuda, fn, width, n, at, bad):
    import subprocess
    import sys

    code = _OUT_OF_RANGE.format(root=ROOT, n_rows=4096, width=width, n=n, at=at, bad=bad,
                                fn=fn)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert "raised:" in r.stdout, (r.stdout, r.stderr[-2000:])


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
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n_rows, width)
    tol = hash_gather.scatter_add_tolerance(idx, cot, want)
    assert bool(((got.double() - want.double()).abs() <= tol).all())


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


# The evaluation slice's shapes: compacted fine batches, marched blocks and
# Blender data (tolerances as above: B1's per-element and percentile bounds;
# a rendered image at PSNR >= 40 dB against the plain path; exact copies).


def _compaction_inputs(cuda, n_rays, n_samples, keep, seed):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (n_rays, n_samples, 3)).astype(np.float32))
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if keep == "ragged":  # 12,345 kept points anywhere: a ragged last tile, unfilled slots
        mask = np.zeros(n_rays * n_samples, bool)
        mask[rng.choice(mask.size, 12_345, replace=False)] = True
        mask = mask.reshape(n_rays, n_samples)
    else:
        mask = rng.uniform(size=(n_rays, n_samples)) < keep
    return pts.to(cuda), torch.from_numpy(d).to(cuda), torch.from_numpy(mask).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_rays,keep", [(256, 64, 0.3), (65_536, 1024, 0.5),
                                             (65_536, 1024, "ragged")])
def test_fused_kernel_on_compacted_batches(lego, cuda, cap, n_rays, keep):
    """B1 on query_masked_compacted's [cap, 1, 3] batch (each point its own
    view direction) against the plain version on the same batch, the
    largest error held to max(5e-2, 2x that of the plain version summed in
    float64) as on the persistent tiles (0.093 on 65,536 random points with
    the flat 5e-2 on this test's first run)."""
    opts = RenderOptions()
    kp = kernel_params(lego, opts, cuda)["fine"]
    pts, d, mask = _compaction_inputs(cuda, n_rays, 192, keep, cap)
    before = fused_mlp.fused_nerf_eval.launches
    got = rend.query_masked_compacted(kp, pts, d, opts, mask, cap)
    assert fused_mlp.fused_nerf_eval.launches == before + 1
    plain = dataclasses.replace(opts, use_fused_mlp=False)
    want = rend.query_masked_compacted(kp, pts, d, plain, mask, cap)
    torch.cuda.synchronize()
    slot = torch.cumsum(mask.reshape(-1).long(), 0) - 1
    kept = (mask.reshape(-1) & (slot < cap)).reshape(mask.shape)
    assert int(kept.sum()) == min(cap, int(mask.sum()))
    flat = kept.reshape(-1)
    kp_pts = pts.reshape(-1, 3)[flat]
    kp_dirs = d[:, None, :].expand(*mask.shape, 3).reshape(-1, 3)[flat]
    want64 = fused_mlp.fused_nerf_eval_plain(kp, kp_pts, kp_dirs, torch.float64)
    spread = float(_fused_rel(want64, want[kept]).max())
    _assert_fused_close(got[kept], want[kept], max(5e-2, 2.0 * spread))
    assert bool((got[~kept] == want[~kept]).all())  # EMPTY_SIGMA_RAW on both


@pytest.mark.cuda
def test_marched_block_kernels_match_plain(lego, cuda):
    """One block of 16,384 rays x 16 samples (262,144 points through B1),
    with ESS, ERT and refocus, against the plain path."""
    opts = RenderOptions()
    params = kernel_params(lego, opts, cuda)
    grid = occupancy.populate_from_density(
        occupancy.init_grid(64, generator=torch.Generator(device=cuda).manual_seed(1),
                            device=cuda), make_density_fn(params["coarse"], opts))
    K = torch.tensor([[180.0, 0, 64], [0, 180.0, 64], [0, 0, 1]], device=cuda)
    o, d = image_rays(128, 128, K, torch.as_tensor(look_at_pose(0.5, 0.3, 4.0), device=cuda))
    before = fused_mlp.fused_nerf_eval.launches
    got = marched.render_rays_marched(params, o.contiguous(), d.contiguous(), opts, grid=grid,
                                      n_blocks=1, block_samples=16)
    assert fused_mlp.fused_nerf_eval.launches == before + 1
    plain = dataclasses.replace(opts, use_fused_mlp=False)
    want = marched.render_rays_marched(params, o.contiguous(), d.contiguous(), plain, grid=grid,
                                       n_blocks=1, block_samples=16)
    assert 0.05 < float(want["acc_map"].mean()) < 0.95
    assert _psnr(got["rgb_map"], want["rgb_map"]) >= 40.0


@pytest.mark.cuda
def test_blender_tensors_reach_the_card_unchanged(cuda, tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (3, 20, 24, 4), dtype=np.uint8)
    poses = np.stack([look_at_pose(t, 0.3, 4.0) for t in (0.0, 1.0, 2.0)])
    write_blender_scene(str(tmp_path / "lego"), {"train": (imgs, poses)}, 0.6911112070083618)
    ds = BlenderDataset(data_root=str(tmp_path), split="train", H=20, W=24)
    u8 = torch.from_numpy(np.round(ds.images * 255).astype(np.uint8))
    for host in (u8, torch.from_numpy(ds.images), torch.from_numpy(ds.poses),
                 torch.from_numpy(ds.K)):
        assert torch.equal(host.to(cuda).cpu(), host)


# phase (a) of chip_smoke.py: ragged tiles of 64 points, a ragged end and
# the lego step's fine batch
F32_SIZES = [1, 63, 64, 127, 128, 129, 65553, 196608]


def _kp32(lego, cuda, model="fine"):
    return {k: v.to(cuda) for k, v in
            fused_mlp.repack_params(lego[model], weight_dtype=torch.float32).items()}


@pytest.mark.cuda
def test_f32_forward_matches_plain(lego, cuda):
    from nerf_tpu_torch.tools import f32_check

    kp = _kp32(lego, cuda)
    errs = []
    for n in F32_SIZES:
        pts, d = _points(n, n + 3, cuda)
        before = fused_mlp.fused_nerf_eval_f32.launches
        errs.append(f32_check.forward_errors(kp, pts, d))
        assert fused_mlp.fused_nerf_eval_f32.launches == before + 1
    assert max(e[0] for e in errs) <= 2.0 * max(e[1] for e in errs), errs


@pytest.mark.cuda
@pytest.mark.parametrize("n", F32_SIZES)
def test_f32_backward_matches_plain(lego, cuda, n):
    from nerf_tpu_torch.tools import f32_check

    kp = _kp32(lego, cuda)
    pts, d = _points(n, n + 4, cuda)
    g = torch.from_numpy(np.random.default_rng(n).normal(size=(n, 4)).astype(np.float32)).to(cuda)
    before = fused_mlp_bwd.fused_nerf_bwd_f32.launches
    res = f32_check.backward_errors(kp, pts, d, g)
    assert fused_mlp_bwd.fused_nerf_bwd_f32.launches == before + 1
    assert res["worst"] <= 1.0, res
    got = fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g)
    no_inputs = fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g, input_grads=False)
    assert no_inputs[1] is None and no_inputs[2] is None
    for k in fused_mlp_bwd._GRAD_KEYS:  # the same launches, without the input gradients
        assert torch.equal(no_inputs[0][k], got[0][k]), k


@pytest.mark.cuda
def test_f32_bad_unit_table_raises(lego, cuda, monkeypatch):
    """A unit table the kernel cannot take is refused at launch (no fallback)."""
    import ctypes

    kp = _kp32(lego, cuda)
    pts, d = _points(128, 3, cuda)
    g = torch.zeros((128, 4), device=cuda)
    units = fused_mlp_bwd.dw_units()
    units[0, fused_mlp_bwd.DW_UNIT_FIELDS.index("xlines")] = 33
    bad = (ctypes.c_int * units.size)(*units.ravel().tolist())
    monkeypatch.setattr(fused_mlp_bwd, "_units_arg", lambda fold_bias=True: (bad, units.shape[0]))
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g)


@pytest.mark.cuda
def test_f32_kernels_are_deterministic_and_rowwise(lego, cuda):
    """Two launches of each give the same bits; a prefix launched alone is
    the same rows of a larger launch (raw, dpts, ddirs); B2-f32's recomputed
    forward is B1-f32's output bit for bit (the same kernel code), and
    chunked launches equal one launch in every row and, per leaf, within
    the backward's bound (the chunks' sums are added in another order)."""
    kp = _kp32(lego, cuda)
    pts, d = _points(84525, 5, cuda)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(84525, 4)).astype(np.float32)).to(cuda)
    full = fused_mlp.fused_nerf_eval(kp, pts, d)
    assert torch.equal(full, fused_mlp.fused_nerf_eval(kp, pts, d))
    a = fused_mlp_bwd.launch_f32(kp, pts, d, g)
    b = fused_mlp_bwd.launch_f32(kp, pts, d, g)
    assert torch.equal(a["raw"], full)
    for k in fused_mlp_bwd._GRAD_KEYS:
        assert torch.equal(a["kgrads"][k], b["kgrads"][k]), k
    assert torch.equal(a["dpts"], b["dpts"]) and torch.equal(a["ddirs"], b["ddirs"])
    for n in (1, 63, 64, 127, 128, 129, 65553):
        part = fused_mlp.fused_nerf_eval(kp, pts[:n].contiguous(), d[:n].contiguous())
        assert torch.equal(part, full[:n]), n
        pb = fused_mlp_bwd.fused_nerf_bwd(kp, pts[:n].contiguous(), d[:n].contiguous(),
                                          g[:n].contiguous())
        assert torch.equal(pb[1], a["dpts"][:n]) and torch.equal(pb[2], a["ddirs"][:n]), n
    c = fused_mlp_bwd.launch_f32(kp, pts, d, g, chunk=8192)
    assert torch.equal(c["raw"], full) and torch.equal(c["dpts"], a["dpts"])
    for k in fused_mlp_bwd._GRAD_KEYS:
        want = a["kgrads"][k]
        assert float((c["kgrads"][k] - want).abs().max()) <= 2e-4 * float(want.abs().max()) + 1e-6, k


@pytest.mark.cuda
def test_f32_train_step_kernels_match_plain(cuda):
    """One lego step with float32 weights through B1-f32, B2-f32 and B3
    against the plain float32 path, the same batch, fine samples and
    knife-edge masking: loss within 1e-5 relative, every gradient leaf
    within 2e-4 of its largest |value| + 1e-6."""
    from nerf_tpu_torch.tools import f32_check
    from nerf_tpu_torch.train import loop
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import init_state, sample_ray_batch

    cfg = make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"),
                   ["occupancy_grid_resolution", "32", "network.dtype", "float32"])
    opts = RenderOptions.from_cfg(cfg)
    template = init_state(loop.init_nerf_params(torch.Generator().manual_seed(0), opts, cuda),
                          make_optimizer(cfg))
    state = load_checkpoint(LEGO, template)[0]
    gen = torch.Generator(device=cuda).manual_seed(0)
    imgs = torch.randint(0, 256, (2, 32, 32, 3), generator=gen, device=cuda, dtype=torch.uint8)
    poses = torch.as_tensor(np.stack([look_at_pose(t, 0.3, 4.0) for t in (0.5, 2.0)]),
                            device=cuda)
    K = torch.tensor([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], device=cuda)
    ro, rd, tgt = sample_ray_batch(gen, imgs, poses, K, 256)
    before = (fused_mlp.fused_nerf_eval_f32.launches, fused_mlp_bwd.fused_nerf_bwd_f32.launches)
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    (lk, gk), (lp, gp) = f32_check.step_pair(state.params, ro, rd, tgt, opts, None, gen, plain)
    torch.cuda.synchronize()
    assert fused_mlp.fused_nerf_eval_f32.launches == before[0] + 2
    assert fused_mlp_bwd.fused_nerf_bwd_f32.launches == before[1] + 2
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for i, (a, b) in enumerate(zip(gk, gp)):
        assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max()) + 1e-6, i


@pytest.mark.cuda
@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_other_shape_renders_through_integrate(cuda, use_viewdirs):
    """A D=4 W=64 frequency NeRF (plain MLP, as JAX's XLA path) rendered with
    B3 against B3's plain version: PSNR >= 40 dB."""
    from nerf_tpu_torch.train import loop

    opts = RenderOptions(mlp_depth=4, mlp_width=64, skips=(2,), xyz_freqs=6, dir_freqs=2,
                         use_viewdirs=use_viewdirs, enable_ess=False, tile_rays=1024,
                         perturb=0.0)
    tree = loop.init_nerf_params(torch.Generator().manual_seed(3), opts, cuda)
    kp = kernel_params(tree, opts, cuda)
    K = torch.tensor([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], device=cuda)
    pose = torch.as_tensor(look_at_pose(0.5, 0.3, 4.0), device=cuda)
    before = tint.integrate.launches
    got = rend.render_image(kp, pose, K, 32, 32, opts)["rgb_map"]
    assert tint.integrate.launches > before
    want = rend.render_image(kp, pose, K, 32, 32,
                             dataclasses.replace(opts, use_integrate_kernel=False))["rgb_map"]
    assert _psnr(got, want) >= 40.0


def _kilo(cuda, rounds=4):
    from nerf_tpu_torch.ops import kilonerf as tk

    cfg = tk.KiloConfig(capacity_factor=3.0, dispatch_rounds=rounds)
    return tk, cfg, tk.init_kilonerf(torch.Generator().manual_seed(0), cfg, cuda)


def _precision():
    mm = torch.backends.cuda.matmul
    return mm.fp32_precision if hasattr(mm, "fp32_precision") else \
        torch.get_float32_matmul_precision()


@pytest.mark.cuda
def test_kilonerf_eval_matches_float64_whatever_tf32(cuda):
    """65,536 points clustered in a few networks (drops in 1 and 4 rounds)."""
    tk, cfg, p = _kilo(cuda)
    pts, dirs = _points(65536, 21, cuda)
    pts = pts * 0.3  # clustered near the centre: far above the mean load
    want = tk.kilonerf_naive(p, pts, dirs, cfg)
    outs = []
    for tf32 in (False, True):
        with tk.matmul_precision(tf32):
            outs.append(tk.kilonerf_eval(p, pts, dirs, cfg))
    assert torch.equal(outs[0], outs[1])
    cap = tk.default_capacity(65536, cfg)
    keep = tk.rank_in_network(tk.assign_networks(pts, cfg), tk.n_networks(cfg)) < 4 * cap
    assert 0 < int((~keep).sum()) < 65536
    rel = (outs[0].double() - want).abs() / (1.0 + want.abs())
    assert float(rel[keep].max()) <= 2e-5
    assert bool((outs[0][~keep] == 0).all())


@pytest.mark.cuda
def test_kilonerf_gradients_match_float64_with_tf32_on(cuda):
    """TF32 allowed by the caller and no wrap around the autograd call: every
    gradient leaf of a loss of kilonerf_eval (4 rounds, with drops) within
    1e-5 of its largest |value| of the per-point evaluation in float64 (the
    backward's products run in full float32 too; TF32 products miss by
    ~1e-4); the caller's setting reads back as it was, inside and after."""
    tk, cfg, p = _kilo(cuda)
    pts, dirs = _points(65536, 23, cuda)
    pts = pts * 0.3
    cot = torch.randn(65536, 4, generator=torch.Generator(device=cuda).manual_seed(2),
                      device=cuda)
    cap = tk.default_capacity(65536, cfg)
    keep = tk.rank_in_network(tk.assign_networks(pts, cfg), tk.n_networks(cfg)) < 4 * cap
    assert 0 < int((~keep).sum()) < 65536

    def leaves(dtype):
        tree = {k: {n: t.detach().to(dtype).requires_grad_(True) for n, t in v.items()}
                for k, v in p.items()}
        return tree, [tree[k][n] for k in tk.LAYERS for n in ("w", "b")]

    t64, l64 = leaves(torch.float64)
    want = torch.autograd.grad((tk.kilonerf_naive(t64, pts, dirs, cfg) * cot.double()
                                * keep[:, None]).sum(), l64)
    before = _precision()
    with tk.matmul_precision(True):
        on = _precision()
        t32, l32 = leaves(torch.float32)
        got = torch.autograd.grad((tk.kilonerf_eval(t32, pts, dirs, cfg) * cot).sum(), l32)
        assert _precision() == on
    assert _precision() == before
    for a, b in zip(got, want):
        assert float((a.double() - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
def test_kilonerf_frame_through_integrate(cuda):
    tk, cfg, p = _kilo(cuda)
    opts = RenderOptions(network_type="kilonerf", kilo_capacity_factor=3.0,
                         kilo_dispatch_rounds=4, enable_ess=False, tile_rays=1024, perturb=0.0)
    kp = kernel_params({"coarse": p, "fine": p}, opts, cuda)
    K = torch.tensor([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], device=cuda)
    pose = torch.as_tensor(look_at_pose(0.5, 0.3, 4.0), device=cuda)
    before = (tint.integrate.launches, fused_mlp.fused_nerf_eval.launches)
    got = rend.render_image(kp, pose, K, 32, 32, opts)["rgb_map"]
    assert tint.integrate.launches > before[0] and fused_mlp.fused_nerf_eval.launches == before[1]
    want = rend.render_image(kp, pose, K, 32, 32,
                             dataclasses.replace(opts, use_integrate_kernel=False))["rgb_map"]
    assert _psnr(got, want) >= 40.0


@pytest.mark.cuda
def test_kilonerf_distill_loss_and_gradients_match_the_cpu(cuda):
    from nerf_tpu_torch.train import distill

    tk, cfg, p = _kilo(cuda, rounds=1)
    pts, dirs = _points(8192, 22, torch.device("cpu"))
    t_raw = torch.randn(8192, 4, generator=torch.Generator().manual_seed(1))
    t_rgb, t_sigma = distill.teacher_targets(t_raw)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = {k: {n: t.detach().to(dev).requires_grad_(True) for n, t in v.items()}
                  for k, v in p.items()}
        loss = distill.distill_loss(leaves, pts.to(dev), dirs.to(dev), t_rgb.to(dev),
                                    t_sigma.to(dev), cfg, capacity=64)
        loss.backward()
        grads.append((float(loss.detach()), [leaves[k][n].grad.cpu() for k in tk.LAYERS
                                            for n in ("w", "b")]))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-5)
    for a, b in zip(grads[0][1], grads[1][1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-12


def _lego_step_inputs(n, seed, dev):
    """n rays of two orbit cameras, random targets and sorted fine samples."""
    rng = np.random.default_rng(seed)
    poses = np.stack([look_at_pose(t, 0.3, 4.0) for t in (0.5, 2.5)]).astype(np.float32)
    K = torch.tensor([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]])
    from nerf_tpu_torch.render.rays import rays_for_pixels

    idx, px, py = rng.integers(0, 2, n), rng.integers(0, 32, n), rng.integers(0, 32, n)
    o, d = rays_for_pixels(torch.from_numpy(px.astype(np.float32)),
                           torch.from_numpy(py.astype(np.float32)), K,
                           torch.from_numpy(poses[idx]))
    tgt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, (n, 128)), -1).astype(np.float32)
    return o.numpy(), d.numpy(), tgt, z


@pytest.mark.cuda
def test_nccl_world_1_step_equals_the_step_without_a_group(cuda, tmp_path):
    """The data-parallel step as rank 0 of 1 over NCCL (a launched process)
    and the step without a group, in-process: the lego state, bf16 kernels,
    256 rays with fed fine samples: the same loss and params bit for bit (one
    rank's all-reduce is the identity, the kernels are deterministic)."""
    from nerf_tpu_torch.parallel import dryrun, mesh
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import apply_step, init_state
    from nerf_tpu_torch.train import loop
    from nerf_tpu_torch.tree import tree_leaves

    cfg_file = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
    cfg = make_cfg(cfg_file, [])
    opts = dataclasses.replace(RenderOptions.from_cfg(cfg), enable_ess=False, perturb=0.0)
    o, d, tgt, z = _lego_step_inputs(256, 1, cuda)
    inp, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(inp, opts=dryrun.opts_json(opts), cfg_file=cfg_file, overrides=np.array([], str),
             ckpt=LEGO, rays_o=o, rays_d=d, target=tgt, z_fine=z)
    mesh.launch("nerf_tpu_torch.parallel.dryrun", ["step", inp, out, "--device", "cuda"], 1,
                "cuda")
    tx = make_optimizer(cfg)
    state = load_checkpoint(LEGO, init_state(loop.init_nerf_params(
        torch.Generator().manual_seed(0), opts, cuda), tx))[0]
    before = fused_mlp_bwd.fused_nerf_bwd.launches
    with dryrun.fed_fine_samples(torch.from_numpy(z).to(cuda)):
        stats = apply_step(state, *(torch.from_numpy(a).to(cuda) for a in (o, d, tgt)), tx, opts)
    assert fused_mlp_bwd.fused_nerf_bwd.launches == before + 2
    with np.load(out) as res:
        assert float(res["loss"]) == float(stats["loss"])
        for i, t in enumerate(tree_leaves(state.params)):
            np.testing.assert_array_equal(res[f"leaf_{i}"], t.detach().cpu().numpy())


@pytest.mark.cuda
def test_kilonerf_ep_world_1_nccl_equals_dense(cuda, tmp_path):
    """kilonerf_eval_ep as rank 0 of 1 over NCCL (a launched process), 16^3
    networks, 65,536 clustered points, capacities that serve every point,
    against kilonerf_eval in-process: equal bit for bit (the exchange of one
    rank moves nothing; the same products run in the same order)."""
    import json

    from nerf_tpu_torch.parallel import dryrun, mesh

    tk, cfg, p = _kilo(cuda)
    pts, dirs = _points(65536, 31, cuda)
    pts = pts * 0.3
    cap = tk.no_drop_capacity(pts, cfg)
    want = tk.kilonerf_eval(p, pts, dirs, cfg, capacity=cap)
    inp, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(inp, cfg=json.dumps(cfg._asdict()), pts=pts.cpu().numpy(), dirs=dirs.cpu().numpy(),
             capacities=np.array([[65536, cap]]), grads=np.array([False]),
             **dryrun.kilo_leaves(p))
    mesh.launch("nerf_tpu_torch.parallel.dryrun", ["ep", inp, out, "--device", "cuda"], 1, "cuda")
    with np.load(out) as res:
        np.testing.assert_array_equal(res["raw_0"], want.cpu().numpy())


@pytest.mark.cuda
def test_kilonerf_train_step_through_b3_matches_plain(cuda, monkeypatch):
    """One KiloNeRF train step (16^3 networks, 4 rounds, 256 rays, fed fine
    samples) compositing through B3 and through its plain version: loss
    within 1e-4 relative, every gradient leaf within 1e-4 of its largest
    |value| (B3's forward sums in another order; both backwards recompute
    the plain compositing)."""
    from nerf_tpu_torch.train import loop
    from nerf_tpu_torch.train.state import loss_and_grads

    cfg = make_cfg(os.path.join(ROOT, "configs", "nerf", "lego_kilonerf.yaml"), [])
    opts = dataclasses.replace(RenderOptions.from_cfg(cfg), perturb=0.0)
    params = loop.init_nerf_params(torch.Generator().manual_seed(0), opts, cuda)
    o, d, tgt, z = _lego_step_inputs(256, 2, cuda)
    monkeypatch.setattr(rend, "sample_pdf", lambda *a, **k: torch.from_numpy(z).to(cuda))
    out = []
    for o_ in (opts, dataclasses.replace(opts, use_integrate_kernel=False)):
        before = tint.integrate.launches
        out.append(loss_and_grads(params, *(torch.from_numpy(a).to(cuda) for a in (o, d, tgt)),
                                  o_, None) + (tint.integrate.launches - before,))
    (lk, _, gk, nk), (lp, _, gp, npl) = out
    assert nk == 2 and npl == 0
    assert float(lk) == pytest.approx(float(lp), rel=1e-4)
    assert len(gk) == 20
    for a, b in zip(gk, gp):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


HASH_ENCODERS = ["hashgrid", "cuda_hashgrid_4d", "cuda_hashgrid_latent", "cuda_hashgrid_coef",
                 "cuda_motion2d", "dnerf_ngp_mlp", "dnerf_ngp_tensorf", "cuda_dnerf_ngp_tensorf"]
# the 3-D grids whose points do not require grad take the hash encoder's kernels
# (hash_coef: its bases, basis_num of them below)
FUSED_TABLES = {"hashgrid": 1, "cuda_hashgrid_latent": 1, "cuda_hashgrid_coef": 3}
# whose tables' cotangent rows carry other features of the same call (hash_coef:
# the coefficient grid's, its bases' features), which the fused path sums in
# another order
BLENDED_TABLES = ("cuda_hashgrid_coef",)


def _encoder_args(etype, n, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.rand((n, 3), generator=g, device=dev) * 4.0 - 2.0
    if etype.startswith("cuda_hashgrid") or etype == "cuda_motion2d":
        t = torch.randint(0, 60, (n, 1), generator=g, device=dev).float()
        return (torch.cat([xyz, t], -1),)
    if etype.startswith(("dnerf", "cuda_dnerf")):
        t = torch.rand((n, 1), generator=g, device=dev)
        t[::4] = 0.0
        return xyz, t
    return (xyz,)


def _encode_grads(fn, params, args, plain, g):
    from nerf_tpu_torch.tree import tree_leaves

    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.grad = None
        leaf.requires_grad_(True)
    out = fn(params, *args, plain=plain)
    (out * g).sum().backward()
    return out.detach(), [leaf.grad.clone() for leaf in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("etype", HASH_ENCODERS)
def test_hash_encoders_through_b4_match_plain(cuda, etype, monkeypatch):
    from nerf_tpu_torch.models.encoders import get_encoder
    from nerf_tpu_torch.ops import hash_encode
    from nerf_tpu_torch.tree import tree_leaves

    cfg = {"type": etype, "log2_hashmap_size": 16, "deform_width": 64, "coef_hidden": 32,
           "basis_num": 3}
    params, fn, dim = get_encoder(cfg, torch.Generator().manual_seed(0), device=cuda)
    leaves = tree_leaves(params)
    with torch.no_grad():  # O(1) tables and a moving deformation head
        for leaf in leaves:
            if leaf.dtype == torch.bfloat16:
                leaf.uniform_(-1, 1)
        if "deform" in params:
            params["deform"]["head"]["w"].uniform_(-0.1, 0.1)
    args = _encoder_args(etype, 20000, cuda, 1)
    g = torch.randn((20000, dim), device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    table_of, seen, fused = {}, [], []
    real_gather, real_scatter = hash_gather.gather_rows, hash_gather.scatter_add_rows
    real_interp, real_interp_bwd = hash_encode.hash_interp, hash_encode.hash_interp_bwd
    bwd_calls = []

    def gather(table, idx):
        table_of[idx.data_ptr()] = table.data_ptr()
        return real_gather(table, idx)

    def scatter(idx, cot, n_rows):
        seen.append((idx, cot, n_rows))
        return real_scatter(idx, cot, n_rows)

    def interp(rows, pts, lv):
        fused.append((rows, pts, lv))
        return real_interp(rows, pts, lv)

    def interp_bwd(g, pts, lv, dtype):
        cot = real_interp_bwd(g, pts, lv, dtype)
        bwd_calls.append((g, pts, lv, dtype, cot))
        return cot

    # the wrappers count on their module-level names, which are the spies meanwhile
    gather.launches = scatter.launches = interp.launches = interp_bwd.launches = 0
    monkeypatch.setattr(hash_gather, "gather_rows", gather)
    monkeypatch.setattr(hash_gather, "scatter_add_rows", scatter)
    monkeypatch.setattr(hash_encode, "hash_interp", interp)
    monkeypatch.setattr(hash_encode, "hash_interp_bwd", interp_bwd)
    n_tables = sum(1 for t in leaves if t.dtype == torch.bfloat16)
    out_k, grads_k = _encode_grads(fn, params, args, False, g)
    assert gather.launches == n_tables == len(seen)
    assert len(fused) == interp.launches == len(bwd_calls) == FUSED_TABLES.get(etype, 0)
    for g_, pts, lv, dtype, cot in bwd_calls:
        assert torch.equal(cot, hash_encode.hash_interp_bwd_plain(g_, pts, lv, dtype))
    out_p, grads_p = _encode_grads(fn, params, args, True, g)
    assert gather.launches == n_tables and len(seen) == n_tables and len(fused) == interp.launches
    if fused:  # the 3-D grids' 8 products summed in another order
        tol = max(float(hash_encode.interp_tolerance(*call).max()) for call in fused)
        assert float((out_k - out_p).abs().max()) <= 2 * tol
    else:
        assert torch.equal(out_k, out_p)
    ptrs = [t.data_ptr() for t in leaves]
    for idx, cot, n_rows in seen:
        i = ptrs.index(table_of[idx.data_ptr()])
        want = hash_gather.scatter_add_rows_plain(idx, cot, n_rows)
        tol = hash_gather.scatter_add_tolerance(idx, cot, want)
        # hash_coef's plain run's cotangent rows may differ in their last bits
        # (its blend weights its bases' features, which differ by the sum
        # order): its tables within 1e-3 in relative norm
        blended = etype in BLENDED_TABLES
        for got in (grads_k[i],) if blended else (grads_k[i], grads_p[i]):
            assert bool(((got.reshape(want.shape).double() - want.double()).abs() <= tol).all())
        if blended:
            assert _rel_norm(grads_p[i].float(), grads_k[i].float()) <= 1e-3
    for a, b, t in zip(grads_k, grads_p, leaves):
        if t.dtype != torch.bfloat16:
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-12


@pytest.mark.cuda
def test_img_fit_step_on_the_card_matches_the_cpu(cuda):
    from nerf_tpu_torch.models.img_fit import apply_img_fit_mlp, init_img_fit_mlp
    from nerf_tpu_torch.tree import tree_leaves

    params = init_img_fit_mlp(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    uv = torch.from_numpy(rng.uniform(0, 1, (8192, 2)).astype(np.float32))
    rgb = torch.from_numpy(rng.uniform(0, 1, (8192, 3)).astype(np.float32))
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        results = []
        for dev in (cuda, torch.device("cpu")):
            p = {k: ([{n: t.to(dev).requires_grad_(True) for n, t in d.items()} for d in v]
                     if isinstance(v, list) else {n: t.to(dev).requires_grad_(True)
                                                  for n, t in v.items()})
                 for k, v in params.items()}
            loss = torch.mean((apply_img_fit_mlp(p, uv.to(dev)) - rgb.to(dev)) ** 2)
            grads = torch.autograd.grad(loss, tree_leaves(p))
            results.append((float(loss.detach()), [x.cpu() for x in grads]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-5)
    for a, b in zip(results[0][1], results[1][1]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-12


@pytest.mark.cuda
def test_tensor_helpers_on_the_card_match_the_cpu(cuda, tmp_path):
    import glob
    import json

    from nerf_tpu_torch.utils import data_utils, profiling, ray_utils

    rng = np.random.default_rng(11)
    o = torch.from_numpy(rng.uniform(-4, 4, (65536, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(65536, 3)).astype(np.float32))
    d[:1024, 0] = 0.0
    box = ([-1.5, -1.5, -1.5], [1.5, 1.5, 1.5])
    want = ray_utils.get_near_far(o, d, *box)
    got = ray_utils.get_near_far(o.to(cuda), d.to(cuda), *box)
    assert got[0].device.type == "cuda"
    assert torch.equal(got[2].cpu(), want[2])
    for g, w in zip(got[:2], want[:2]):
        assert float((g.cpu() - w).abs().max()) <= 1e-6
    heat = torch.from_numpy((rng.permutation(4 * 8 * 32 * 32).reshape(4, 8, 32, 32) + 0.5)
                            .astype(np.float32) / 32768 - 0.25)
    nms = data_utils.heatmap_nms(heat.to(cuda))
    assert torch.equal(nms.cpu(), data_utils.heatmap_nms(heat))
    for g, w in zip(data_utils.topk(nms, 40), data_utils.topk(data_utils.heatmap_nms(heat), 40)):
        assert torch.equal(g.cpu(), w)
    stats = profiling.memory_stats()
    assert stats["cuda:0"]["bytes_in_use"] > 0
    assert stats["cuda:0"]["peak_bytes_in_use"] >= stats["cuda:0"]["bytes_in_use"]
    service = RenderService(make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"),
                                     ["trained_model_dir", LEGO]), size=64, device=cuda)
    service.render(0.5, 0.3, 4.0)
    with profiling.trace(str(tmp_path)) as log_dir:
        profiling.sync(service.render(0.5, 0.3, 4.0))
    (path,) = glob.glob(os.path.join(log_dir, "*.json"))
    kernels = {e.get("name", "") for e in json.load(open(path))["traceEvents"]
               if e.get("cat") == "kernel"}
    assert any("fused_nerf" in n for n in kernels) and any("integrate" in n for n in kernels)
