"""Instant-NGP's NeRF network in the port (``models/ngp.py``, the renderer's
``query_ngp``, the exp density, the optimizer's per-leaf rules) against the
plain reference ``nerf_tpu_torch/models/ngp_reference.py``.

On the CPU, at a small size (4 levels, 2^10 rows a level, 64 rays of 16
samples) with seeded weights whose table is drawn wide enough to move the
outputs (U(+-4)): raw outputs, composited maps, every leaf's gradient
and one optimizer step; the config, one network in the train state, a
checkpoint's round trip and a tiny ``render_image``.

Tolerances. The float32 path computes what the reference computes in
another order of float32 sums (the hash gradient as ``index_add_`` against
autograd's indexing, compositing's log-sum against a cumprod), so it agrees
to 1e-5 of each quantity's largest value. The bf16 path rounds both
operands of each of the five products to bfloat16 (2^-9 each) and sums in
float32: its error is held under 3 x 2^-8 of the same products taken on the
magnitudes (|h| @ |w| through the layers), a first-order bound with room.

On the card (``-m cuda``; the file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ngp.py

B3's exp density against its plain version (forward, and the backward
through ``composite_kernel``), the card's query (B4's gather, bf16 MLPs)
against the reference, and the Adam kernel with the L2 term and the skip
against ``step_plain``, bit for bit, with its count of skipped elements.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.models import ngp, ngp_reference as ref
from nerf_tpu_torch.render.renderer import (RenderOptions, kernel_params, query_ngp,
                                            render_image, render_rays)
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import init_state, loss_and_grads
from nerf_tpu_torch.tree import tree_leaves

YAML = os.path.join(os.path.dirname(__file__), "..", "nerf_tpu_torch", "configs", "lego_ngp.yaml")
SMALL = ["network.xyz_encoder.n_levels", "4", "network.xyz_encoder.log2_hashmap_size", "10",
         "task_arg.N_samples", "16", "task_arg.perturb", "0", "enable_ess", "False"]
N_RAYS = 64


def small_cfg(*extra):
    return make_cfg(YAML, SMALL + list(extra))


def spec_of(opts: RenderOptions) -> ref.Spec:
    return ref.Spec(levels=opts.hash_levels, features=opts.hash_features,
                    log2_size=opts.hash_log2_size, base=opts.hash_base_res,
                    scale=opts.hash_scale, bound=opts.hash_bound,
                    ert=opts.ert_threshold, white_bkgd=opts.white_bkgd)


def seeded_net(opts: RenderOptions, device="cpu", seed=0):
    """Xavier weights, the density MLP's times 4, over a U(+-4) table: log
    densities spread by a few units, so that rays range from empty to opaque."""
    gen = torch.Generator().manual_seed(seed)
    net = ngp.init_ngp(gen, opts.ngp_shapes(), opts.hash_levels, opts.hash_features,
                       opts.hash_log2_size, table_scale=4.0, device=device)
    with torch.no_grad():
        for layer in net["density_mlp"]:
            layer["w"].mul_(4.0)
    return net


def rays(device="cpu", seed=1, n=N_RAYS):
    gen = torch.Generator().manual_seed(seed)
    ang = torch.rand(n, 2, generator=gen) * torch.tensor([6.2832, 1.2])
    o = 4.0 * torch.stack([torch.cos(ang[:, 1]) * torch.cos(ang[:, 0]),
                           torch.cos(ang[:, 1]) * torch.sin(ang[:, 0]), torch.sin(ang[:, 1])], -1)
    d = -o + torch.randn(n, 3, generator=gen) * 0.3
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    target = torch.rand(n, 3, generator=gen)
    return o.to(device), d.to(device), target.to(device)


def z_vals(opts: RenderOptions, n: int, device="cpu"):
    t = torch.linspace(0.0, 1.0, opts.n_samples, device=device)
    return (opts.near * (1.0 - t) + opts.far * t).expand(n, opts.n_samples)


def detached(net):
    return {"color_mlp": [{"w": l["w"].detach()} for l in net["color_mlp"]],
            "density_mlp": [{"w": l["w"].detach()} for l in net["density_mlp"]],
            "xyz_encoder": {"table": net["xyz_encoder"]["table"].detach()}}


def magnitude(net, opts, pts, dirs):
    """|rgb logits| and |log density| bounds: the products on magnitudes."""
    spec = spec_of(opts)
    absnet = {k: [{"w": l["w"].abs()} for l in net[k]] for k in ("color_mlp", "density_mlp")}
    absnet["xyz_encoder"] = {"table": net["xyz_encoder"]["table"].abs()}
    rows, w = ref.corner_rows(spec, pts)
    L, T, F = absnet["xyz_encoder"]["table"].shape
    feats = (absnet["xyz_encoder"]["table"].reshape(L * T, F)[rows] * w[..., None]).sum(2)
    geo = feats.permute(1, 0, 2).reshape(pts.shape[0], -1)
    for l in absnet["density_mlp"]:
        geo = geo @ l["w"]
    h = torch.cat([geo, ref.sh_basis(dirs).abs()], -1)
    for l in absnet["color_mlp"]:
        h = h @ l["w"]
    return h, geo[:, 0]


# --- the config -------------------------------------------------------------

def test_the_yaml_gives_instant_ngps_network():
    opts = RenderOptions.from_cfg(make_cfg(YAML, []))
    assert opts.ngp and opts.hashgrid and opts.n_importance == 0 and opts.n_samples == 64
    assert (opts.hash_levels, opts.hash_features, opts.hash_log2_size) == (16, 2, 19)
    assert (opts.hash_base_res, opts.hash_scale, opts.hash_bound) == (16, 1.3819, 1.5)
    assert opts.hash_dtype == "float32" and opts.compute_dtype == "bfloat16"
    assert opts.sigma_activation == "exp" and opts.ert_threshold == 1e-4
    assert opts.ngp_shapes() == {"density_mlp": [(32, 64), (64, 16)],
                                 "color_mlp": [(32, 64), (64, 64), (64, 3)]}
    n_max = int(np.floor(16 * 1.3819 ** 15))
    assert 2040 <= n_max <= 2060
    tx = make_optimizer(make_cfg(YAML, []))
    assert (tx.b1, tx.b2, tx.eps, tx.l2_reg, tx.skip_zero_grads) == (0.9, 0.99, 1e-15, 1e-6, True)
    assert tx.lr(tx.init([])) == pytest.approx(1e-2)


@pytest.mark.parametrize("override", [["task_arg.N_importance", "128"],
                                      ["network.dir_encoder.type", "frequency"],
                                      ["network.dir_encoder.degree", "3"]])
def test_from_cfg_refuses_what_the_network_is_not(override):
    with pytest.raises(ValueError):
        RenderOptions.from_cfg(make_cfg(YAML, override))


def test_the_train_state_holds_one_network_at_published_size():
    from nerf_tpu_torch.train.loop import init_nerf_params

    cfg = make_cfg(YAML, [])
    opts = RenderOptions.from_cfg(cfg)
    params = init_nerf_params(torch.Generator().manual_seed(0), opts)
    assert list(params) == ["coarse"]
    table = params["coarse"]["xyz_encoder"]["table"]
    assert table.numel() == 16_777_216 and table.dtype == torch.float32
    assert float(table.detach().abs().max()) <= 1e-4
    mlp = sum(p.numel() for p in tree_leaves(params)) - table.numel()
    assert mlp == 9_408
    state = init_state(params, make_optimizer(cfg))
    assert len(state.opt_state.mu) == len(tree_leaves(params)) == 6


# --- the forward ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_raw_outputs_agree_with_the_reference(dtype):
    opts = RenderOptions.from_cfg(small_cfg("network.dtype", dtype))
    net = seeded_net(opts)
    o, d, _ = rays()
    z = z_vals(opts, N_RAYS)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    with torch.no_grad():
        got = query_ngp(detached(net), pts, d, opts).reshape(-1, 4)
        flat_d = d[:, None, :].expand_as(pts).reshape(-1, 3)
        rgb, log_sigma = ref.forward(spec_of(opts), detached(net), pts.reshape(-1, 3), flat_d)
    want = torch.cat([rgb, log_sigma[:, None]], -1)
    assert float(want[:, :3].std()) > 0.02 and float(want[:, 3].std()) > 0.02  # the table matters
    err = (got - want).abs()
    if dtype == "float32":
        assert float(err.max()) <= 1e-5 * float(want.abs().max())
    else:
        mag_rgb, mag_sigma = magnitude(detached(net), opts, pts.reshape(-1, 3), flat_d)
        bound = 3 * 2.0 ** -8 * torch.cat([mag_rgb, mag_sigma[:, None]], -1)
        assert bool((err <= bound).all()), float((err / bound).max())


def test_maps_agree_with_the_reference():
    opts = RenderOptions.from_cfg(small_cfg("network.dtype", "float32"))
    net = detached(seeded_net(opts))
    o, d, _ = rays()
    out = render_rays({"coarse": net}, o, d, opts)
    want = ref.render(spec_of(opts), net, o, d, z_vals(opts, N_RAYS))
    for got_k, want_k in (("rgb_map_0", "rgb"), ("acc_map_0", "acc"), ("depth_map_0", "depth")):
        err = float((out[got_k] - want[want_k]).abs().max())
        assert err <= 1e-5 * float(want[want_k].abs().max()), (got_k, err)
    # the surfaces lie at depths that differ by ray, and ERT cuts samples
    assert float(want["depth"].std()) > 0.05 and bool((want["weights"] == 0).any())


def test_exp_density_fills_masked_samples_with_zero():
    from nerf_tpu_torch.render.composite import EMPTY_SIGMA_RAW, density_activation

    assert float(density_activation(torch.tensor(EMPTY_SIGMA_RAW), "exp")) == 0.0
    assert float(density_activation(torch.tensor(0.0), "exp")) == 1.0


# --- gradients and the optimizer -------------------------------------------

def _grads(opts, net):
    o, d, target = rays()
    params = {"coarse": net}
    _, _, grads = loss_and_grads(params, o, d, target, opts, None)
    rnet = {"color_mlp": [{"w": l["w"].detach().clone().requires_grad_(True)}
                          for l in net["color_mlp"]],
            "density_mlp": [{"w": l["w"].detach().clone().requires_grad_(True)}
                            for l in net["density_mlp"]],
            "xyz_encoder": {"table": net["xyz_encoder"]["table"].detach().clone()
                            .requires_grad_(True)}}
    out = ref.render(spec_of(opts), rnet, o, d, z_vals(opts, N_RAYS))
    want = torch.autograd.grad(ref.loss(out["rgb"], target), tree_leaves(rnet))
    return grads, list(want)


def test_every_leafs_gradient_agrees_with_the_reference():
    opts = RenderOptions.from_cfg(small_cfg("network.dtype", "float32"))
    net = seeded_net(opts)
    got, want = _grads(opts, net)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert scale > 0
        assert float((g - w).abs().max()) <= 1e-5 * scale
    table_g = want[-1]
    assert 0 < int((table_g != 0).sum()) < table_g.numel()  # rows the batch never touched


@pytest.mark.parametrize("l2", [1e-6, 0.1])
def test_one_optimizer_step_agrees_with_the_reference(l2):
    cfg = small_cfg("network.dtype", "float32", "train.l2_reg", str(l2))
    opts = RenderOptions.from_cfg(cfg)
    net = seeded_net(opts)
    tx = make_optimizer(cfg)
    state = init_state({"coarse": net}, tx)
    grads, _ = _grads(opts, net)
    leaves = tree_leaves(state.params)
    before = [p.detach().clone() for p in leaves]
    lr = tx.lr(state.opt_state)
    tx.step(leaves, grads, state.opt_state)
    paths = ["color_mlp", "color_mlp", "color_mlp", "density_mlp", "density_mlp", "table"]
    for i, (p0, g, path) in enumerate(zip(before, grads, paths)):
        table = path == "table"
        want_p, want_mu, want_nu = ref.adam_step(
            p0, g, torch.zeros_like(g), torch.zeros_like(g), 1, lr, l2=0.0 if table else l2,
            skip_zero=table)
        # both sides round p + update to float32 once (2^-24 of |p| each)
        assert bool(((leaves[i].detach() - want_p).abs()
                     <= 1e-5 * lr + 2.0 ** -23 * p0.abs()).all())
        assert float((state.opt_state.mu[i] - want_mu).abs().max()) <= 1e-6 * float(
            want_mu.abs().max())
        if table:
            untouched = g == 0
            assert bool(untouched.any())
            assert torch.equal(leaves[i].detach()[untouched], p0[untouched])
            assert bool((state.opt_state.nu[i][untouched] == 0).all())
    assert tx.rules[-1].skip and tx.rules[-1].l2 == 0.0
    assert all(r.l2 == pytest.approx(l2) and not r.skip for r in tx.rules[:-1])


def test_lego_binds_no_rules():
    cfg = make_cfg(os.path.join(os.path.dirname(YAML), "..", "..", "configs", "nerf", "lego.yaml"),
                   [])
    tx = make_optimizer(cfg)
    init_state({"coarse": {"w": torch.zeros(2, requires_grad=True)}}, tx)
    assert tx.rules is None and (tx.b2, tx.eps) == (0.999, 1e-8)


# --- the checkpoint and the render path ------------------------------------

def test_checkpoint_round_trip_and_load_params(tmp_path):
    from nerf_tpu_torch.train.checkpoint import load_checkpoint, load_params, save_checkpoint

    cfg = small_cfg()
    opts = RenderOptions.from_cfg(cfg)
    tx = make_optimizer(cfg)
    state = init_state({"coarse": seeded_net(opts)}, tx)
    save_checkpoint(str(tmp_path), state, 3)
    back = load_checkpoint(str(tmp_path), init_state({"coarse": seeded_net(opts, seed=5)}, tx))[0]
    for a, b in zip(tree_leaves(state.params), tree_leaves(back.params)):
        assert torch.equal(a.detach(), b.detach())
    loaded = load_params(str(tmp_path), **opts.model_shape())
    assert list(loaded) == ["coarse"]
    for a, b in zip(tree_leaves(state.params), tree_leaves(loaded)):
        assert np.array_equal(a.detach().numpy(), b)


def test_ngp_check_gathers_the_yamls_table_at_the_encoders_rows(monkeypatch):
    """``tools/ngp_check.py`` at 64 points on the CPU: one float32 table of
    16 x 2^19 rows of 2 drawn U(+-1), each level's 8 corner rows a point
    inside that level's rows, and its hash check passing (the CPU's gather
    and scatter-add are the plain versions)."""
    from nerf_tpu_torch.tools import ngp_check

    monkeypatch.setattr(ngp_check, "N_POINTS", 64)
    dev = torch.device("cpu")
    _, opts, _, state = ngp_check.ngp_state(dev)
    table = state.params["coarse"]["xyz_encoder"]["table"].detach()
    assert table.shape == (16, 1 << 19, 2) and table.dtype == torch.float32
    assert 0.99 < float(table.abs().max()) <= 1.0
    idx = ngp_check.rows(opts, dev)
    assert idx.dtype == torch.int32 and idx.shape == (16 * 64 * 8,)
    level = torch.arange(16)[:, None] * (1 << 19)
    by_level = idx.reshape(16, -1).long()
    assert bool(((by_level >= level) & (by_level < level + (1 << 19))).all())
    got = ngp_check.check_hash(table.reshape(-1, 2), idx)
    assert got["gather_rows"] == idx.shape[0] and got["scatter_worst_over_tol"] == 0.0


def test_tiny_render_image_through_the_normal_dispatch():
    from nerf_tpu_torch.render import occupancy as occ
    from nerf_tpu_torch.train.loop import make_density_fn

    opts = RenderOptions.from_cfg(small_cfg("network.dtype", "float32", "enable_ess", "True"))
    opts = dataclasses.replace(opts, tile_rays=100)
    net = detached(seeded_net(opts))
    kp = kernel_params({"coarse": net}, opts)
    grid = occ.populate_from_density(occ.init_grid(8, generator=torch.Generator().manual_seed(1)),
                                     make_density_fn(net, opts))
    pose = torch.eye(4)
    pose[2, 3] = 4.0
    K = torch.tensor([[20.0, 0.0, 8.0], [0.0, 20.0, 8.0], [0.0, 0.0, 1.0]])
    out = render_image(kp, pose, K, 16, 16, opts, grid=grid)
    assert out["rgb_map_0"].shape == (16, 16, 3) and "rgb_map" not in out
    assert bool(torch.isfinite(out["rgb_map_0"]).all())
    # with every voxel occupied ESS leaves the even samples the reference takes
    full = render_image(kp, pose, K, 16, 16, opts, grid=occ.full_grid(8))
    want = ref.render(spec_of(opts), net, *_pose_rays(pose, K), z_vals(opts, 256))
    assert float((full["rgb_map_0"].reshape(-1, 3) - want["rgb"]).abs().max()) <= 1e-5


def _pose_rays(pose, K):
    from nerf_tpu_torch.render.rays import image_rays

    return image_rays(16, 16, K, pose)


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ert", [0.0, 1e-4])
def test_b3_exp_against_its_plain_version(cuda, ert):
    from nerf_tpu_torch.ops import integrate as tint
    from nerf_tpu_torch.render.composite import composite

    gen = torch.Generator(device=cuda).manual_seed(0)
    for n, s in ((4096, 64), (1024, 192)):
        raw = torch.randn((n, s, 4), generator=gen, device=cuda)
        raw[..., 3] *= 2.0
        z = torch.sort(torch.rand((n, s), generator=gen, device=cuda) * 4.0 + 2.0, -1).values
        d = torch.randn((n, 3), generator=gen, device=cuda)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        got = tint.integrate(raw, z, d, ert, True, "exp")
        want = tint.integrate_plain(raw, z, d, ert, True, "exp")
        for k in ("rgb_map", "depth_map", "acc_map", "weights"):
            assert float((got[k] - want[k]).abs().max()) <= 2e-5 * (1 + float(want[k].abs().max()))
        if ert > 0:
            beyond, _ = tint.past_the_cut(tint.plain_transmittance(raw, z, d, "exp"), ert)
            assert int((got["weights"][beyond] != 0).sum()) == 0
        # the backward: composite's vjp behind the kernel's forward
        r1 = raw.clone().requires_grad_(True)
        r2 = raw.clone().requires_grad_(True)
        out = tint.composite_kernel(r1, z, d, ert_threshold=ert, sigma_activation="exp")
        ref_out = composite(r2, z, d, ert_threshold=ert if ert > 0 else None,
                            sigma_activation="exp")
        g1, = torch.autograd.grad(out["rgb_map"].sum() + out["depth_map"].sum(), r1)
        g2, = torch.autograd.grad(ref_out["rgb_map"].sum() + ref_out["depth_map"].sum(), r2)
        assert float((g1 - g2).abs().max()) <= 1e-5 * (1 + float(g2.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_query_against_the_reference(cuda, dtype):
    from nerf_tpu_torch.ops import hash_gather

    opts = RenderOptions.from_cfg(make_cfg(YAML, ["network.dtype", dtype]))
    net = detached(seeded_net(opts, device=cuda))
    o, d, _ = rays(cuda, n=2048)
    z = z_vals(opts, 2048, cuda)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    before = hash_gather.gather_rows.launches
    with torch.no_grad():
        got = query_ngp(net, pts, d, opts).reshape(-1, 4)
        flat_d = d[:, None, :].expand_as(pts).reshape(-1, 3)
        rgb, log_sigma = ref.forward(spec_of(opts), net, pts.reshape(-1, 3), flat_d)
    assert hash_gather.gather_rows.launches == before + 1
    want = torch.cat([rgb, log_sigma[:, None]], -1)
    err = (got - want).abs()
    if dtype == "float32":
        assert float(err.max()) <= 1e-5 * float(want.abs().max())
    else:
        mag_rgb, mag_sigma = magnitude(net, opts, pts.reshape(-1, 3), flat_d)
        bound = 3 * 2.0 ** -8 * torch.cat([mag_rgb, mag_sigma[:, None]], -1)
        assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.cuda
def test_adam_kernel_with_l2_and_skip_equals_step_plain(cuda):
    from nerf_tpu_torch.train import optim
    from nerf_tpu_torch.utils import profiling

    sched = optim.exponential_epoch_schedule(1e-2, 0.33, 20, 500)
    gen = torch.Generator(device=cuda).manual_seed(3)

    def tree():
        t = torch.randn((4, 3000, 2), generator=gen, device=cuda)
        return {"density_mlp": [{"w": torch.randn((32, 64), generator=gen, device=cuda)}],
                "color_mlp": [{"w": torch.randn((67, 3), generator=gen, device=cuda)}],
                "xyz_encoder": {"table": t}}

    base = tree()
    sides = []
    for _ in range(2):
        params = {k: ([{"w": l["w"].clone()} for l in v] if isinstance(v, list)
                      else {"table": v["table"].clone()}) for k, v in base.items()}
        tx = optim.Optimizer(sched, b2=0.99, eps=1e-15, l2_reg=0.05, skip_zero_grads=True)
        sides.append((params, tx, init_state(params, tx)))
    for step in range(3):
        grads = [torch.randn(p.shape, generator=gen, device=cuda) * 30 for p in tree_leaves(base)]
        grads[-1][torch.rand(grads[-1].shape, generator=gen, device=cuda) < 0.6] = 0.0
        grads[-1][0, :5] = -0.0
        zeros = int((grads[-1] == 0).sum())
        (p1, tx1, s1), (p2, tx2, s2) = sides
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.reset()
            tx1.step(tree_leaves(p1), grads, s1.opt_state)
            counts = profiling.counters()
        tx2.step_plain(tree_leaves(p2), grads, s2.opt_state)
        assert counts["adam.skipped"] == zeros and counts["adam.elements"] == grads[-1].numel()
        for a, b in zip(tree_leaves(p1) + s1.opt_state.mu + s1.opt_state.nu,
                        tree_leaves(p2) + s2.opt_state.mu + s2.opt_state.nu):
            assert torch.equal(a, b)
