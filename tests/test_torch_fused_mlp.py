"""nerf_tpu_torch encoder, MLP and fused-MLP plain path against nerf_tpu.

The JAX side runs as nerf_tpu's own tests run it on the CPU: the Pallas
kernel in interpret mode, the MLP on the XLA path. Inputs come from
numpy.random.default_rng; the weights are the committed lego model's.

Tolerances:
- float32: atol 2e-4 (as tests/test_fused_mlp.py) plus rtol 2e-6, because
  the lego sigma reaches ~700 and float32 sums in another order differ by
  a few ulp of that.
- bfloat16: both sides round every activation to bf16 but sum in float32 in
  another order; where a sum lands next to a bf16 rounding boundary the two
  round it differently, and that one-ulp (0.4%) step propagates to the
  outputs. So the bound is 5% of (1 + |want|) per element, and 99% of the
  elements must agree to 1e-4 of (1 + |want|).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.encoders import freq_encode as jax_freq_encode
from nerf_tpu.models.nerf_mlp import apply_nerf_mlp
from nerf_tpu.ops import fused_mlp as jax_fused

from nerf_tpu_torch.models.encoders import freq_encode, freq_out_dim
from nerf_tpu_torch.ops import fused_mlp
from nerf_tpu_torch.train.checkpoint import from_jax_params, load_params

LEGO = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "nerf", "lego", "nerf")
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def lego():
    return load_params(LEGO)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, d / np.linalg.norm(d, axis=-1, keepdims=True)


def assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-6)
        return
    rel = np.abs(got - want) / (1.0 + np.abs(want))
    assert rel.max() <= 5e-2, rel.max()
    assert np.percentile(rel, 99) <= 1e-4, np.percentile(rel, 99)


@pytest.mark.parametrize("num_freqs", [4, 10])
def test_freq_encode_matches_jax(num_freqs):
    x = np.random.default_rng(num_freqs).uniform(-2, 2, (64, 3)).astype(np.float32)
    got = freq_encode(torch.from_numpy(x), num_freqs).numpy()
    want = np.asarray(jax_freq_encode(jnp.asarray(x), num_freqs))
    assert got.shape == (64, freq_out_dim(3, num_freqs))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_repack_matches_jax(lego, dtype):
    tdt, jdt = DTYPES[dtype]
    want = jax_fused.repack_params(jax.tree_util.tree_map(jnp.asarray, lego["coarse"]),
                                   weight_dtype=jdt)
    got = fused_mlp.repack_params(lego["coarse"], weight_dtype=tdt)
    for k, v in want.items():
        assert got[k].dtype == (tdt if k.startswith("w") else torch.float32), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v.astype(jnp.float32)), err_msg=k)


def test_kernel_buffer_layout(lego):
    """wbuf/bbuf hold the matrices at the offsets csrc/fused_mlp.cu reads."""
    kp = fused_mlp.repack_params(lego["coarse"])
    wbuf, bbuf = kp["wbuf"], kp["bbuf"]
    assert wbuf.shape == (fused_mlp.WBUF_SIZE,) and wbuf.dtype == torch.bfloat16
    assert bbuf.shape == (fused_mlp.BBUF_SIZE,) and bbuf.dtype == torch.float32

    def seg(off, rows, cols):
        return wbuf[off: off + rows * cols].reshape(rows, cols)

    w0 = seg(0, 64, 256)
    torch.testing.assert_close(w0[:63], torch.cat([kp["w0x"], kp["w0s"], kp["w0c"]]))
    assert not w0[63].any()
    torch.testing.assert_close(seg(16384 + 3 * 65536, 256, 256), kp["w4"])
    w5 = seg(278528, 320, 256)
    torch.testing.assert_close(w5[:3], kp["w5x"])
    assert not w5[63].any()
    torch.testing.assert_close(w5[64:], kp["w5h"])
    torch.testing.assert_close(seg(491520, 256, 256), kp["wf"])
    wv = seg(557056, 288, 128)
    torch.testing.assert_close(wv[:256], kp["wvf"])
    torch.testing.assert_close(wv[256:283], torch.cat([kp["wvx"], kp["wvs"], kp["wvc"]]))
    assert not wv[283:].any()
    torch.testing.assert_close(seg(593920, 256, 1), kp["wa"])
    torch.testing.assert_close(seg(594176, 128, 3), kp["wr"])
    torch.testing.assert_close(bbuf[5 * 256: 6 * 256], kp["b5"][0])
    torch.testing.assert_close(bbuf[2432:], torch.cat([kp["ba"][0], kp["br"][0]]))


def _random_tree(like, seed):
    """A model of the lego shapes with weights from a numpy seed."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (rng.normal(size=np.shape(v)) * 0.1).astype(np.float32), like)


def _layer_matrices(kp):
    """The ten [K, N] layer matrices, built from repack_params' named entries
    (not from its buffers), the encoding rows zero-padded to 16-multiples."""
    def pad(w):
        return torch.cat([w, w.new_zeros((-w.shape[0]) % 16, w.shape[1])])

    emb0 = pad(torch.cat([kp["w0x"], kp["w0s"], kp["w0c"]]))
    emb5 = pad(torch.cat([kp["w5x"], kp["w5s"], kp["w5c"]]))
    embv = pad(torch.cat([kp["wvx"], kp["wvs"], kp["wvc"]]))
    return [emb0, kp["w1"], kp["w2"], kp["w3"], kp["w4"], torch.cat([emb5, kp["w5h"]]),
            kp["w6"], kp["w7"], kp["wf"], torch.cat([kp["wvf"], embv])]


@pytest.mark.parametrize("model", ["lego", "random"])
def test_weight_stream_gives_back_every_matrix(lego, model):
    """wpack, the wgmma kernel's weight stream, unpacks to every layer matrix
    exactly, zero padding included, and holds element (k, n) of a [K, N]
    layer at (k // 8) * N * 8 + n * 8 + k % 8 from the layer's start."""
    tree = lego["coarse"] if model == "lego" else _random_tree(lego["coarse"], 3)
    kp = fused_mlp.repack_params(tree)
    wpack = kp["wpack"]
    assert wpack.shape == (fused_mlp.WPACK_SIZE,) and wpack.dtype == torch.bfloat16
    want = _layer_matrices(kp)
    got = fused_mlp.unpack_weight_stream(wpack)
    assert [tuple(m.shape) for m in got] == list(fused_mlp.STREAM_LAYERS)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
    assert not got[0][63].any() and not got[5][63].any() and not got[9][283:].any()
    off = sum(k * n for k, n in fused_mlp.STREAM_LAYERS[:9])  # the view layer [288, 128]
    for k, n in ((0, 0), (7, 127), (8, 1), (283, 5), (287, 127)):
        assert wpack[off + (k // 8) * 128 * 8 + n * 8 + k % 8] == want[9][k, n]
    torch.testing.assert_close(fused_mlp.pack_weight_stream(kp["wbuf"]), wpack, rtol=0, atol=0)


@pytest.mark.parametrize("model", ["lego", "random"])
def test_repack_keeps_the_backward_buffers(lego, model):
    """wbuf and bbuf, which the backward kernel reads, are the layer matrices
    row-major in layer order, then wa and wr, and the biases in order."""
    tree = lego["coarse"] if model == "lego" else _random_tree(lego["coarse"], 4)
    kp = fused_mlp.repack_params(tree)
    wbuf = torch.cat([m.reshape(-1) for m in _layer_matrices(kp)]
                     + [kp["wa"].reshape(-1), kp["wr"].reshape(-1)])
    bbuf = torch.cat([kp[k].reshape(-1) for k in ("b0", "b1", "b2", "b3", "b4", "b5", "b6",
                                                  "b7", "bf", "bv", "ba", "br")])
    assert torch.equal(kp["wbuf"], wbuf) and torch.equal(kp["bbuf"], bbuf)
    assert wbuf.numel() == fused_mlp.WBUF_SIZE and bbuf.numel() == fused_mlp.BBUF_SIZE


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [512, 300])  # 300: not a multiple of the tile
def test_plain_matches_pallas_interpret(lego, dtype, n):
    tdt, jdt = DTYPES[dtype]
    pts, d = _points(n, seed=n)
    jkp = jax_fused.repack_params(jax.tree_util.tree_map(jnp.asarray, lego["coarse"]),
                                  weight_dtype=jdt)
    want = jax_fused.fused_nerf_eval(jkp, jnp.asarray(pts), jnp.asarray(d), tile=256,
                                     interpret=True)
    kp = fused_mlp.repack_params(lego["coarse"], weight_dtype=tdt)
    got = fused_mlp.fused_nerf_eval_plain(kp, torch.from_numpy(pts), torch.from_numpy(d))
    assert got.shape == (n, 4) and got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_nerf_mlp_matches_apply_nerf_mlp(lego, dtype):
    tdt, jdt = DTYPES[dtype]
    pts, d = _points(256, seed=7)
    emb = np.concatenate([np.asarray(jax_freq_encode(jnp.asarray(pts), 10)),
                          np.asarray(jax_freq_encode(jnp.asarray(d), 4))], -1)
    want = apply_nerf_mlp(jax.tree_util.tree_map(jnp.asarray, lego["fine"]),
                          jnp.asarray(emb), input_ch=63, compute_dtype=jdt)
    model = from_jax_params(lego)["fine"]
    with torch.no_grad():
        got = model(torch.from_numpy(emb), compute_dtype=tdt)
    assert_close(got.numpy(), np.asarray(want), dtype)


def test_plain_matches_nerf_mlp(lego):
    """The repacked, phase-split plain path computes the module's function."""
    pts, d = _points(256, seed=8)
    model = from_jax_params(lego)["coarse"]
    x = torch.cat([freq_encode(torch.from_numpy(pts), 10), freq_encode(torch.from_numpy(d), 4)], -1)
    with torch.no_grad():
        want = model(x)
    kp = fused_mlp.repack_params(model.to_tree(), weight_dtype=torch.float32)
    got = fused_mlp.fused_nerf_eval_plain(kp, torch.from_numpy(pts), torch.from_numpy(d))
    assert_close(got.numpy(), want.numpy(), "float32")


def test_wrapper_on_cpu_is_the_plain_version(lego):
    kp = fused_mlp.repack_params(lego["coarse"])
    pts, d = (torch.from_numpy(a) for a in _points(64, seed=9))
    before = fused_mlp.fused_nerf_eval.launches
    got = fused_mlp.fused_nerf_eval(kp, pts, d)
    torch.testing.assert_close(got, fused_mlp.fused_nerf_eval_plain(kp, pts, d), rtol=0, atol=0)
    assert fused_mlp.fused_nerf_eval.launches == before  # no kernel launched


def test_wrapper_is_forward_only(lego):
    kp = fused_mlp.repack_params(lego["coarse"])
    pts = torch.zeros(4, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_mlp.fused_nerf_eval(kp, pts, torch.zeros(4, 3))


def test_query_network_broadcasts_viewdirs(lego):
    kp = fused_mlp.repack_params(lego["coarse"], weight_dtype=torch.float32)
    pts, d = _points(6 * 5, seed=10)
    pts = torch.from_numpy(pts).reshape(6, 5, 3)
    d = torch.from_numpy(d[:6])
    raw = fused_mlp.query_network(kp, pts, d)
    assert raw.shape == (6, 5, 4)
    want = fused_mlp.fused_nerf_eval_plain(kp, pts[2], d[2:3].expand(5, 3))
    torch.testing.assert_close(raw[2], want)


def test_supports_gate():
    from nerf_tpu_torch.render.renderer import RenderOptions

    assert fused_mlp.supports(RenderOptions())
    assert not fused_mlp.supports(RenderOptions(mlp_width=128))
    assert not fused_mlp.supports(RenderOptions(xyz_freqs=8))


def test_plain_float64_sums_agree_with_float32_sums(lego):
    """The float64-sum plain version is the same bf16 function: float32
    weights give float32 sums either way (atol as the float32 bound), and
    bf16 weights stay within the bf16 bound above."""
    kp32 = fused_mlp.repack_params(lego["coarse"], weight_dtype=torch.float32)
    kp16 = fused_mlp.repack_params(lego["coarse"])
    pts, d = (torch.from_numpy(a) for a in _points(512, seed=11))
    for kp, dtype in ((kp32, "float32"), (kp16, "bfloat16")):
        got = fused_mlp.fused_nerf_eval_plain(kp, pts, d, torch.float64)
        want = fused_mlp.fused_nerf_eval_plain(kp, pts, d)
        assert got.dtype == torch.float32
        assert_close(got.numpy(), want.numpy(), dtype)


def test_fused_variants_apply_to_the_kernel_source():
    """Every variant of tools/fused_variants.py still finds the lines it
    replaces in csrc/fused_mlp.cu (the tool raises when one does not)."""
    from nerf_tpu_torch.tools import fused_variants

    src = fused_variants.SOURCE.read_text()
    for name in fused_variants.VARIANTS:
        out = fused_variants.variant_source(name, src)
        assert (out == src) == (name == "kernel"), name


def test_fused_accuracy_tool_runs_on_the_cpu(capsys):
    """The GPU measurement script, at a tiny size on the CPU (where the
    kernel wrapper is the plain version, so kernel and plain agree exactly)."""
    from nerf_tpu_torch.tools import fused_accuracy

    assert fused_accuracy.main(["--device", "cpu", "--size", "8",
                                "occupancy_grid_resolution", "4",
                                "render_tile_rays", "48"]) == 0
    lines = capsys.readouterr().out.splitlines()
    heads = [l for l in lines if not l.startswith(" ")]
    assert [h.split(",")[0] for h in heads] == [
        "first tile coarse", "first tile fine", "last tile coarse", "last tile fine",
        "ESS slab 0 of 1"]
    assert sum("kernel vs plain   max 0," in l for l in lines) == 5
