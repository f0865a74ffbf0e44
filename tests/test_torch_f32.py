"""The float32 fused-MLP kernels' host side (B1-f32, B2-f32), on the CPU.

The kernels run on the card only (``tests/test_torch_cuda.py``); here:
- the float32 weight packing that they read (``repack_params`` with
  float32 weights: ``wbuf`` as the forward reads it, ``wbuf_t`` the
  backward chain's transposed parts): exact;
- the wrappers on CPU tensors run the plain versions, bit for bit; the
  float32 wrappers refuse weights of another dtype on a device;
- ``check_weight_dtype`` takes bf16 and float32 weights on a CUDA device
  and still refuses float16 for the fused kernels;
- ``fused_mlp_bwd.knife_edge_points`` (the float64 margins that the card's
  float32 backward checks mask) zeroes 28 of tests/test_torch_fused_bwd.py's
  640 points, and a larger constant marks a superset: exact;
- the backward's chunks and the tensor-core weight gradients' splits.
"""
import os

import numpy as np
import pytest
import torch

from nerf_tpu_torch.ops import fused_mlp, fused_mlp_bwd
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.render.renderer import RenderOptions, check_weight_dtype, kernel_params
from nerf_tpu_torch.train.checkpoint import load_params

LEGO = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "nerf", "lego", "nerf")


@pytest.fixture(scope="module")
def lego():
    return load_params(LEGO)


@pytest.fixture(scope="module")
def kp32(lego):
    return fused_mlp.repack_params(lego["fine"], weight_dtype=torch.float32)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(pts), torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))


def test_float32_packing_is_exact(kp32):
    """wbuf holds every matrix as the bf16 packing does, in float32; wbuf_t
    holds part (i, r0, rows) of BWD_STREAM as W_i[r0:r0+rows]^T row-major:
    element (k, n) at n * rows + (k - r0) from the part's start."""
    assert kp32["wbuf"].dtype == torch.float32 and kp32["wbuf"].shape == (fused_mlp.WBUF_SIZE,)
    wbuf, bbuf = fused_mlp._pack_kernel_buffers(kp32)
    assert torch.equal(kp32["wbuf"], wbuf) and torch.equal(kp32["bbuf"], bbuf)
    assert "wpack" not in kp32 and "wpack_bwd" not in kp32
    wt = kp32["wbuf_t"]
    assert wt.dtype == torch.float32 and wt.shape == (fused_mlp.WPACK_SIZE,)
    mats = fused_mlp._stream_matrices(kp32["wbuf"])
    for got, want in zip(fused_mlp.unpack_bwd_rows(wt), mats):
        assert torch.equal(got, want)
    off = 0
    for i, r0, rows in fused_mlp.BWD_STREAM:
        n_out = fused_mlp.STREAM_LAYERS[i][1]
        for k, n in ((r0, 0), (r0 + rows - 1, n_out - 1), (r0 + rows // 2, 9)):
            assert wt[off + n * rows + (k - r0)] == mats[i][k, n]
        off += rows * n_out
    assert off == fused_mlp.WPACK_SIZE
    # the repacked float32 weights are the checkpoint's values, unrounded
    w1 = torch.from_numpy(np.asarray(load_params(LEGO)["fine"]["pts_linears"][1]["w"]))
    assert torch.equal(mats[1], w1)


def test_bf16_packing_is_unchanged(lego):
    kp = fused_mlp.repack_params(lego["fine"])
    assert "wbuf_t" not in kp
    assert torch.equal(kp["wpack"], fused_mlp.pack_weight_stream(kp["wbuf"]))
    assert torch.equal(kp["wpack_bwd"], fused_mlp.pack_bwd_stream(kp["wbuf"]))


def test_float32_wrappers_run_the_plain_versions_on_cpu(kp32):
    pts, d = _points(100, 1)
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(100, 4)).astype(np.float32))
    before = (fused_mlp.fused_nerf_eval_f32.launches, fused_mlp_bwd.fused_nerf_bwd_f32.launches)
    assert torch.equal(fused_mlp.fused_nerf_eval_f32(kp32, pts, d),
                       fused_mlp.fused_nerf_eval_plain(kp32, pts, d))
    got = fused_mlp_bwd.fused_nerf_bwd_f32(kp32, pts, d, g)
    want = fused_mlp_bwd.fused_nerf_bwd_plain(kp32, pts, d, g)
    for k in fused_mlp_bwd._GRAD_KEYS:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    # no kernel was launched
    assert before == (fused_mlp.fused_nerf_eval_f32.launches,
                      fused_mlp_bwd.fused_nerf_bwd_f32.launches)


def test_float32_wrappers_refuse_other_weights_on_a_device(lego):
    kp = {k: v.to("meta") for k, v in fused_mlp.repack_params(lego["fine"]).items()}
    pts, d = (t.to("meta") for t in _points(8, 3))
    with pytest.raises(ValueError, match="wbuf"):
        fused_mlp.fused_nerf_eval_f32(kp, pts, d)
    with pytest.raises(ValueError, match="wbuf"):
        fused_mlp_bwd.fused_nerf_bwd_f32(kp, pts, d, torch.zeros((8, 4), device="meta"))


@pytest.mark.parametrize("dtype,refused", [("bfloat16", False), ("float32", False),
                                           ("float16", True)])
def test_check_weight_dtype(dtype, refused):
    cuda = torch.device("cuda")
    opts = RenderOptions(compute_dtype=dtype)
    if refused:
        with pytest.raises(NotImplementedError, match="bfloat16 or float32"):
            check_weight_dtype(opts, cuda)
    else:
        check_weight_dtype(opts, cuda)
    # the plain versions, the CPU and models the fused kernel does not cover
    # take any dtype
    import dataclasses
    for o, dev in ((dataclasses.replace(opts, use_fused_mlp=False), cuda),
                   (opts, torch.device("cpu")),
                   (dataclasses.replace(opts, mlp_width=64), cuda),
                   (dataclasses.replace(opts, xyz_encoder_type="hashgrid"), cuda)):
        check_weight_dtype(o, dev)


def test_kernel_params_in_float32(lego):
    kp = kernel_params(lego, RenderOptions(compute_dtype="float32"))
    for name in ("coarse", "fine"):
        assert kp[name]["wbuf"].dtype == torch.float32 and "wbuf_t" in kp[name]
    pts, d = _points(64, 4)
    raw = renderer.query(kp["fine"], pts[:, None], d, RenderOptions(compute_dtype="float32"))
    want = fused_mlp.fused_nerf_eval_plain(kp["fine"], pts, d)
    assert torch.equal(raw[:, 0], want)


def test_knife_edge_points_count():
    """On tests/test_torch_fused_bwd.py's float32 inputs (nerf_tpu's
    PRNGKey(5) weights, _inputs(640, 7)) the margins zero 28 points, and a
    smaller constant marks a subset of a larger one's."""
    import jax

    from nerf_tpu.models.nerf_mlp import init_nerf_mlp
    from test_torch_fused_bwd import _inputs

    params = jax.tree_util.tree_map(np.asarray, init_nerf_mlp(
        jax.random.PRNGKey(5), input_ch=63, input_ch_views=27))
    kp = fused_mlp.repack_params(params, weight_dtype=torch.float32)
    pts, d = (torch.from_numpy(a) for a in _inputs(640, 7)[:2])
    hit = {c: fused_mlp_bwd.knife_edge_points(kp, pts, d, c) for c in (16, 32, 64)}
    assert int(hit[64].sum()) == 28
    assert bool((hit[16] <= hit[32]).all() and (hit[32] <= hit[64]).all())


@pytest.mark.parametrize("n,splits", [(1, 1), (64 * 64, 8), (64 * 128, 16), (196_608, 33),
                                      (1 << 18, 33)])
def test_f32_backward_splits(n, splits):
    """The tensor-core weight gradients' point ranges (at most 33, the
    fastest count measured on the H100; at least 8 tiles a range)."""
    assert fused_mlp_bwd.f32_splits_for(n) == splits
    assert fused_mlp_bwd.F32_CHUNK % fused_mlp_bwd.F32_TILE == 0
