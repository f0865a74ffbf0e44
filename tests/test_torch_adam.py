"""The multi-tensor Adam kernel (``csrc/adam.cu``, ``ops/adam.py``) and the
optimizer's two paths (``train/optim.py``: ``step``, ``step_plain``).

On the CPU: the host's launch plan (leaves grouped by dtype, the prefix sums
of their tiles, a split when the argument block is full), the argument
block's cache, the kernel's scalars against the constants the loop uses,
the loop against the parent's loop written out, CPU leaves through
``step_plain``, the engagement counters and their benchmark reader.

On the card (``-m cuda``; the file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_adam.py

the kernel against ``step_plain`` on the card bit for bit, p, mu and nu over
3 steps, for Adam, RAdam (both of its branches) and SGD, weight decay 0 and
0.01, clipped and bare, float32 and bfloat16 leaves of 1, 3, 257 and 65,537
elements and an unaligned view, gradients across the clip at +-40; the
card's division by a Python scalar as a product with its float reciprocal;
one lego train step through the kernel against the loop on the step's own
gradients, bit for bit.
"""
import ctypes
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from nerf_tpu_torch.ops import adam
from nerf_tpu_torch.train import optim
from nerf_tpu_torch.utils import profiling

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.abspath(ROOT))
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
F32, BF16 = torch.float32, torch.bfloat16
SIZES = (1, 3, 257, 65537)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tx(kind, wd=0.0, bare=False):
    sched = optim.exponential_epoch_schedule(5e-4, 0.1, 500, 7)
    return optim.Optimizer(sched, kind=kind, weight_decay=wd, bare=bare)


# --- the launch plan --------------------------------------------------------

def test_plan_groups_leaves_by_dtype_and_sums_their_tiles():
    t = adam.TILE
    numels = [1, 3, 257, 65537, 0, t, t + 1, 5]
    dtypes = [F32, BF16, F32, F32, F32, BF16, F32, BF16]
    got = adam.plan(numels, dtypes)
    assert got == [adam.Launch(F32, (0, 2, 3, 6), (0, 1, 2, 2 + 33, 2 + 33 + 2)),
                   adam.Launch(BF16, (1, 5, 7), (0, 1, 2, 3))]


def test_plan_splits_when_the_argument_block_is_full():
    n = 2 * adam.MAX_LEAVES + 6
    got = adam.plan([2 * adam.TILE + 1] * n, [F32] * n)
    assert [len(lc.leaves) for lc in got] == [adam.MAX_LEAVES, adam.MAX_LEAVES, 6]
    assert [i for lc in got for i in lc.leaves] == list(range(n))
    for lc in got:
        assert lc.tile_start == tuple(3 * k for k in range(len(lc.leaves) + 1))


def test_plan_takes_only_float32_and_bfloat16():
    assert adam.plan([], []) == []
    assert adam.plan([0, 0], [F32, BF16]) == []
    with pytest.raises(ValueError, match="float16"):
        adam.plan([4], [torch.float16])


def test_the_argument_block_fits_a_launchs_parameters():
    size, n_leaves, tile_start, numel, p, g, m, v, max_leaves, tile, l2, skip, skipped = \
        adam.layout()
    assert size <= 4096 and max_leaves == adam.MAX_LEAVES and tile == adam.TILE
    assert n_leaves == ctypes.sizeof(adam._Scalars) and tile_start == n_leaves + 4
    assert numel % 8 == 0 and [g - p, m - g, v - m, l2 - v] == [8 * max_leaves] * 4
    assert [skip - l2, skipped - skip, size - skipped] == [4 * max_leaves, 4 * max_leaves, 8]


def test_the_table_is_rebuilt_only_when_a_pointer_moves(monkeypatch):
    built = []
    monkeypatch.setattr(adam, "_blocks", lambda p, m, v, r: built.append(1) or ["block"])
    params = [torch.zeros(3), torch.zeros(5)]
    mu, nu = [torch.zeros(3), torch.zeros(5)], [torch.zeros(3), torch.zeros(5)]
    table = adam.Table()
    table.update(params, mu, nu)
    table.update(params, mu, nu)
    assert len(built) == 1 and table.blocks == ["block"]
    mu = [mu[0], mu[1].clone()]  # a checkpoint's load: new moments
    table.update(params, mu, nu)
    table.update(params, mu, nu)
    assert len(built) == 2
    table.update(params, None, None)  # SGD: no moments
    assert len(built) == 3
    rules = (adam.Rule(1e-6, False), adam.Rule(0.0, True))  # per-leaf rules bound
    table.update(params, None, None, rules)
    table.update(params, None, None, rules)
    assert len(built) == 4


def test_the_kernel_refuses_cpu_leaves_and_other_dtypes():
    p, g = [torch.zeros(4)], [torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA"):
        adam.adam(adam.Table(), p, g, [torch.zeros(4)], [torch.zeros(4)], lambda dt: None)
    with pytest.raises(ValueError, match="gradients"):
        adam.adam(adam.Table(), p, g + g, None, None, lambda dt: None)


# --- the constants ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["adam", "radam", "sgd"])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("count", [0, 5, 12499])  # RAdam: ro < 5, then >= 5
def test_the_kernels_scalars_are_the_loops_constants(kind, dtype, count):
    f = np.float32
    tx = _tx(kind, wd=0.01)
    state = tx.init([torch.zeros(2, dtype=dtype)])
    state.count, state.sched_count = count, count
    s = tx.scalars(state)
    o = tx.operands(s, dtype)
    got = adam.scalars(o, kind, tx.bare, s.rect, True)
    c = (lambda v: v) if dtype == F32 else (lambda v: optim._rounded(v, dtype))
    lr = tx.schedule(count)
    if kind == "sgd":
        assert s == optim.StepScalars(count, 1.0, 1.0, 1.0, True, float(-lr))
    else:
        t = count + 1
        b2t = optim._ipow(0.999, t)
        assert s.count == t and s.neg_lr == float(-lr)
        assert s.bc1 == float(f(1.0) - optim._ipow(0.9, t)) and s.bc2 == float(f(1.0) - b2t)
        ro = f(1999.0) - f(2 * t) * b2t / (f(1.0) - b2t)
        assert s.rect == (kind == "adam" or ro >= 5.0)
    assert o == optim.Operands(c(1.0 - 0.9), c(0.9), c(1.0 - 0.999), c(0.999), c(s.bc1),
                               c(s.bc2), c(1e-8), c(s.r), c(0.01), c(s.neg_lr))
    if dtype == BF16:  # each constant a bfloat16 value
        assert all(float(torch.tensor(v).to(BF16)) == v for v in o)
    want = [f(o.omb1), f(o.b1), f(o.omb2), f(o.b2), f(1.0) / f(o.bc1), f(1.0) / f(o.bc2),
            f(o.eps), f(o.r), f(o.wd), f(o.neg_lr)]
    assert [getattr(got, n) for n, _ in got._fields_[:10]] == want
    assert (got.kind, got.bare, got.rect, got.decay) == (adam.KINDS.index(kind), 0,
                                                         int(s.rect), 1)


# --- the loop ---------------------------------------------------------------

def _parent_loop(tx, params, grads, state):
    """The optimizer's step as the loop was written before the kernel: the
    reference that ``step_plain`` must equal bit for bit."""
    f32 = np.float32
    if tx.kind != "sgd":
        count = state.count + 1
        b2t = optim._ipow(tx.b2, count)
        bc1, bc2 = float(f32(1.0) - optim._ipow(tx.b1, count)), float(f32(1.0) - b2t)
        if tx.kind == "radam":
            ro_inf = 2.0 / (1.0 - tx.b2) - 1.0
            ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1.0) - b2t)
            r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                        / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        state.count = count
    neg_lr = -tx.schedule(state.sched_count or 0)
    for i, (p, g) in enumerate(zip(params, grads)):
        def c(v):
            return v if p.dtype == torch.float32 else optim._rounded(v, p.dtype)

        if not tx.bare:
            g = g.clamp(-optim.CLIP, optim.CLIP)
        if tx.kind == "sgd":
            u = g
        else:
            mu = c(1.0 - tx.b1) * g + c(tx.b1) * state.mu[i]
            nu = c(1.0 - tx.b2) * (g * g) + c(tx.b2) * state.nu[i]
            state.mu[i], state.nu[i] = mu, nu
            mu_hat, nu_hat = mu / c(bc1), nu / c(bc2)
            if tx.kind == "adam" or ro >= 5.0:
                u = mu_hat / (torch.sqrt(nu_hat) + c(tx.eps))
                if tx.kind == "radam":
                    u = c(float(r)) * u
            else:
                u = mu_hat
        if tx.weight_decay > 0:
            u = u + c(tx.weight_decay) * p
        p.add_(u * c(float(neg_lr)))
    if state.sched_count is not None:
        state.sched_count += 1


def _leaves(dtypes, dev, seed, sizes=SIZES):
    """Params of ``sizes`` in each dtype, and a leaf that is a view one
    element into a larger tensor (unaligned)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for dt in dtypes:
        out += [torch.randn(n, generator=g).to(dt).to(dev) for n in sizes]
        out.append(torch.randn(1001, generator=g).to(dt).to(dev)[1:])
    return out


def _grads(params, step, dev):
    """Gradients with many beyond the clip at +-40, and some at its edge."""
    g = torch.Generator().manual_seed(100 + step)
    out = []
    for p in params:
        x = torch.randn(p.shape, generator=g) * 30.0
        x.view(-1)[:4] = torch.tensor([40.0, -40.0, 40.5, -1e6])[:x.numel()]
        out.append(x.to(p.dtype).to(dev))
    return out


def _state(tx, params, start, seed):
    state = tx.init(params)
    state.count = start
    if state.sched_count is not None:
        state.sched_count = start
    if state.mu is not None and start:
        g = torch.Generator().manual_seed(seed)
        for i, p in enumerate(params):
            state.mu[i] = (torch.randn(p.shape, generator=g) * 0.1).to(p.dtype).to(p.device)
            state.nu[i] = (torch.rand(p.shape, generator=g) * 1e-2).to(p.dtype).to(p.device)
    return state


def _copy(params, state):
    cl = lambda xs: None if xs is None else [x.clone() for x in xs]  # noqa: E731
    return [p.clone() for p in params], dataclasses.replace(state, mu=cl(state.mu),
                                                            nu=cl(state.nu))


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == BF16 else torch.int32)


def _assert_same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(_bits(x), _bits(y)), f"leaf {i}"


@pytest.mark.parametrize("kind", ["adam", "radam", "sgd"])
@pytest.mark.parametrize("wd,bare", [(0.0, False), (0.01, False), (0.0, True)])
@pytest.mark.parametrize("start", [0, 10])
def test_step_plain_is_the_parent_loop(kind, wd, bare, start):
    tx = _tx(kind, wd, bare)
    params = _leaves([F32, BF16], "cpu", 1, sizes=(1, 3, 257))
    state = _state(tx, params, start, 2)
    ref_p, ref_s = _copy(params, state)
    for step in range(3):
        grads = _grads(params, step, "cpu")
        tx.step_plain(params, grads, state)
        _parent_loop(tx, ref_p, grads, ref_s)
        _assert_same(params, ref_p)
        if state.mu is not None:
            _assert_same(state.mu, ref_s.mu)
            _assert_same(state.nu, ref_s.nu)
        assert (state.count, state.sched_count) == (ref_s.count, ref_s.sched_count)


def test_a_resumed_lego_state_is_what_the_kernel_takes():
    """The committed lego file holds rgb_linear's weights and their moments
    in Fortran order; the kernel updates contiguous tensors in place and
    takes no others, so the state loads contiguous, as ``init`` makes it,
    and ``load_params`` gives C-order arrays."""
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train import loop
    from nerf_tpu_torch.train.checkpoint import load_checkpoint, load_params
    from nerf_tpu_torch.train.state import init_state
    from nerf_tpu_torch.tree import tree_leaves

    with np.load(os.path.join(LEGO, "latest.npz")) as data:
        assert not data["leaf_21"].flags.c_contiguous
    cfg = make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"), [])
    tx = optim.make_optimizer(cfg)
    template = init_state(loop.init_nerf_params(torch.Generator().manual_seed(0),
                                                RenderOptions.from_cfg(cfg), "cpu"), tx)
    state = load_checkpoint(LEGO, template)[0]
    for st in (template, state):
        leaves = tree_leaves(st.params) + st.opt_state.mu + st.opt_state.nu
        assert len(leaves) == 3 * 48 and all(t.is_contiguous() for t in leaves)
    arrays = tree_leaves(load_params(LEGO))  # what bench.py turns into trained tensors
    assert len(arrays) == 48 and all(a.flags.c_contiguous for a in arrays)


def test_cpu_leaves_take_step_plain_and_are_counted(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the kernel was called for CPU leaves")

    monkeypatch.setattr(adam, "adam", no_kernel)
    tx = _tx("adam")
    params = _leaves([F32], "cpu", 3)
    state = tx.init(params)
    ref_p, ref_s = _copy(params, state)
    grads = _grads(params, 0, "cpu")
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tx.step(params, grads, state)
        counts = profiling.counters()
    tx.step_plain(ref_p, grads, ref_s)
    _assert_same(params, ref_p)
    _assert_same(state.mu, ref_s.mu)
    assert counts["optim.leaves"] == len(params) and "optim.fused_leaves" not in counts


def test_the_launch_counter_is_among_the_programs_counters():
    assert profiling.counters()["launches.adam"] == adam.adam.launches


def test_the_benchmark_reads_the_fused_share(monkeypatch):
    from portbench import bench, spans

    reader = bench.metric_reader("optim_fused_pct.train")
    for counts, want in (({"optim.leaves": 96, "optim.fused_leaves": 96}, 100.0),
                         ({"optim.leaves": 96, "optim.fused_leaves": 48}, 50.0),
                         ({"optim.leaves": 96}, 0.0), ({}, None), (None, None),
                         ({"launches.integrate": 3}, None)):
        monkeypatch.setattr(spans, "program_counters", lambda c=counts: c)
        assert reader.read(None) == want


# --- on the card ------------------------------------------------------------

def _run_both(tx, params, state, dev, steps=3):
    """``steps`` steps through the kernel and through step_plain from the
    same state on the same gradients; each step's p, mu and nu bit for bit."""
    ref_p, ref_s = _copy(params, state)
    for step in range(steps):
        grads = _grads(params, step, dev)
        before = adam.adam.launches
        tx.step(params, grads, state)
        tx.step_plain(ref_p, grads, ref_s)
        torch.cuda.synchronize()
        assert adam.adam.launches > before
        _assert_same(params, ref_p)
        if state.mu is not None:
            _assert_same(state.mu, ref_s.mu)
            _assert_same(state.nu, ref_s.nu)
        assert (state.count, state.sched_count) == (ref_s.count, ref_s.sched_count)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adam", "radam", "sgd"])
@pytest.mark.parametrize("wd,bare", [(0.0, False), (0.01, False), (0.0, True), (0.01, True)])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("start", [0, 10])  # RAdam: ro < 5 in its first steps, >= 5 by then
def test_kernel_equals_step_plain_bit_for_bit(cuda, kind, wd, bare, dtype, start):
    tx = _tx(kind, wd, bare)
    params = _leaves([dtype], cuda, 5)
    state = _state(tx, params, start, 6)
    if kind == "radam":
        assert tx.scalars(state).rect == (start == 10)
    _run_both(tx, params, state, cuda)


@pytest.mark.cuda
def test_kernel_takes_mixed_dtypes_and_more_leaves_than_a_block(cuda):
    tx = _tx("adam", 0.01)
    params = _leaves([F32, BF16], cuda, 7) + _leaves([F32], cuda, 8, sizes=(5,) * 70)
    state = _state(tx, params, 3, 9)
    before = adam.adam.launches
    _run_both(tx, params, state, cuda, steps=2)
    assert adam.adam.launches - before == 2 * 3  # float32 in two blocks, bfloat16 in one


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    tx = _tx("adam")
    params = [torch.zeros(8, device=cuda), torch.zeros(4, 4, device=cuda)]
    state = tx.init(params)
    good = [torch.ones(8, device=cuda), torch.ones(4, 4, device=cuda)]
    for bad, what in (([good[0], good[1].t()], "contiguous"),
                      ([good[0], good[1].double()], "float64"),
                      ([good[0], good[1].cpu()], "cpu"),
                      ([good[0], torch.ones(4, 5, device=cuda)], "shape")):
        with pytest.raises(ValueError, match=what):
            tx.step(params, bad, state)
    with pytest.raises(ValueError, match="float16"):
        tx.step([torch.zeros(8, device=cuda, dtype=torch.float16)],
                [torch.ones(8, device=cuda, dtype=torch.float16)],
                tx.init([torch.zeros(8, device=cuda, dtype=torch.float16)]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_the_card_divides_by_a_python_scalar_through_its_reciprocal(cuda, dtype):
    """What the kernel's 1/bc follows: PyTorch on the card computes x / s for
    a Python scalar s as x * (1 / float32(s)), one rounding less exact."""
    g = torch.Generator().manual_seed(11)
    x = (torch.rand(1 << 16, generator=g) * 4).to(dtype).to(cuda)
    for s in (0.1, 0.0951, 3.7e-3, optim._rounded(0.0951, BF16)):
        s = s if dtype == F32 else optim._rounded(s, dtype)
        inv = float(np.float32(1.0) / np.float32(s))
        want = (x.float() * inv).to(dtype)
        assert torch.equal(_bits(x / s), _bits(want)), s


@pytest.mark.cuda
def test_lego_train_step_through_the_kernel_equals_the_loop(cuda):
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.serve import look_at_pose
    from nerf_tpu_torch.train import loop
    from nerf_tpu_torch.train.checkpoint import load_checkpoint
    from nerf_tpu_torch.train.state import init_state, train_step
    from nerf_tpu_torch.tree import tree_leaves

    cfg = make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"),
                   ["occupancy_grid_resolution", "32"])
    opts = RenderOptions.from_cfg(cfg)
    tx = optim.make_optimizer(cfg)
    state = load_checkpoint(LEGO, init_state(loop.init_nerf_params(
        torch.Generator().manual_seed(0), opts, cuda), tx))[0]
    gen = torch.Generator(device=cuda).manual_seed(0)
    imgs = torch.randint(0, 256, (2, 32, 32, 3), generator=gen, device=cuda, dtype=torch.uint8)
    poses = torch.as_tensor(np.stack([look_at_pose(t, 0.3, 4.0) for t in (0.5, 2.0)]),
                            device=cuda)
    K = torch.tensor([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], device=cuda)
    seen = {}
    real = tx.step

    def spy(params, grads, st):
        seen["ref"] = _copy([p.detach() for p in params], st)
        seen["grads"] = [g.clone() for g in grads]
        real(params, grads, st)

    tx.step = spy
    before = adam.adam.launches
    train_step(state, imgs, poses, K, tx, opts, 256, None, gen)
    torch.cuda.synchronize()
    assert adam.adam.launches == before + 1  # lego's 48 float32 leaves: one launch
    (ref_p, ref_s), grads = seen["ref"], seen["grads"]
    assert len(ref_p) == 48 and all(p.dtype == F32 for p in ref_p)
    tx.step_plain(ref_p, grads, ref_s)
    _assert_same([p.detach() for p in tree_leaves(state.params)], ref_p)
    _assert_same(state.opt_state.mu, ref_s.mu)
    _assert_same(state.opt_state.nu, ref_s.nu)
    assert state.opt_state.count == ref_s.count


@pytest.mark.cuda
def test_the_counters_show_every_lego_leaf_fused(cuda):
    tx = _tx("adam")
    params = _leaves([F32], cuda, 12)
    state = tx.init(params)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tx.step(params, _grads(params, 0, cuda), state)
        counts = profiling.counters()
    assert counts["optim.leaves"] == counts["optim.fused_leaves"] == len(params)
