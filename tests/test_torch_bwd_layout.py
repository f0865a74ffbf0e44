"""The layouts of nerf_tpu_torch's fused backward (B2), checked on the CPU.

The CUDA backward (csrc/fused_mlp_bwd.cu) keeps its activation stash and
layer gradients in slabs of 8 columns x 64 points ([P/64][C/8][64][8]), the
forward's ReLU masks as bits in its threads' accumulator order, and streams
each layer's W^T from ``wpack_bwd``. The wrapper packs, unpacks and checks
these in plain PyTorch; every check here is exact (they only move and
compare bits). The kernels themselves run in tests/test_torch_cuda.py.
"""
import os

import numpy as np
import pytest
import torch

from nerf_tpu_torch.ops import fused_mlp, fused_mlp_bwd as fb
from nerf_tpu_torch.train.checkpoint import load_params
from nerf_tpu_torch.tree import tree_map

LEGO = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "nerf", "lego", "nerf")
STASH_WIDTH, GBUF_WIDTH = 2528, 2432


@pytest.fixture(scope="module")
def lego():
    return load_params(LEGO)


def _model(lego, name):
    """The lego coarse MLP, or a model of its shapes with weights from a numpy seed."""
    if name == "lego":
        return lego["coarse"]
    rng = np.random.default_rng(3)
    return tree_map(lambda v: torch.from_numpy(
        (rng.normal(size=tuple(v.shape)) * 0.1).astype(np.float32)), lego["coarse"])


def _points(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(pts), torch.from_numpy(d)


@pytest.mark.parametrize("width", [STASH_WIDTH, GBUF_WIDTH])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 130, 200])
def test_slabs_round_trip(width, n):
    """pack_slabs / unpack_slabs give back a numpy-seeded [P, C] bf16 tensor,
    P a multiple of 64 or not; element (p, c) sits at [p // 64, c // 8,
    p % 64, c % 8] and the rows past P are zero."""
    rng = np.random.default_rng(n + width)
    t = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32)).to(torch.bfloat16)
    s = fb.pack_slabs(t)
    assert s.shape == ((n + 63) // 64, width // 8, 64, 8) and s.is_contiguous()
    assert torch.equal(fb.unpack_slabs(s, n), t)
    for p, c in ((0, 0), (n - 1, width - 1), (n // 2, 1000 % width)):
        assert s[p // 64, c // 8, p % 64, c % 8] == t[p, c]
    assert not fb.unpack_slabs(s, s.shape[0] * 64)[n:].any()


def _stash_rows(acts):
    """The kernel's [P, 2528] stash row layout of plain_activations' dict, bf16."""
    p = acts["h1"].shape[0]
    stash = torch.zeros((p, STASH_WIDTH), dtype=torch.bfloat16)
    for k, c in fb.STASH_COLS.items():
        stash[:, c: c + acts[k].shape[1]] = acts[k].to(torch.bfloat16)
    return stash


@pytest.mark.parametrize("n", [64, 100])
def test_stash_activations_of_a_slab_stash(lego, n):
    """A stash packed into slabs and unpacked, as launch() returns it, gives
    stash_activations the plain forward's activations rounded to bf16, and
    the phases of the plain forward exactly."""
    kp = fused_mlp.repack_params(lego["coarse"])
    pts, d = _points(n, n)
    acts = fb.plain_activations(kp, pts, d)
    stash = fb.unpack_slabs(fb.pack_slabs(_stash_rows(acts)), n)
    got = fb.stash_activations(kp, stash, pts, d)
    for k in fb.STASH_COLS:
        assert torch.equal(got[k], acts[k].to(torch.bfloat16).float()), k
    for k in ("x", "sa", "ca", "d", "sb", "cb"):
        assert torch.equal(got[k], acts[k]), k


@pytest.mark.parametrize("model", ["lego", "random"])
def test_mask_bits_are_the_relu_masks(lego, model):
    """mask_bits of 128 points' activations unpacks to exactly h > 0 of every
    trunk output and of v; bit 4 (j % 8) + e of word j / 8 of thread t holds
    the element the thread's accumulator fragment holds there; bf16 rounding
    keeps every bit."""
    kp = fused_mlp.repack_params(_model(lego, model))
    pts, d = _points(128, 5)
    acts = fb.plain_activations(kp, pts, d)
    bits = fb.mask_bits(acts)
    assert bits.shape == (2, fb.MASK_BLOCK_BYTES) and bits.dtype == torch.uint8
    back = fb.unpack_mask_bits(bits)
    for k in fb.MASK_LAYERS:
        assert torch.equal(back[k], acts[k] > 0), k
        assert 0 < int(back[k].sum()) < back[k].numel(), k  # both kinds of unit occur
    rounded = {k: acts[k].to(torch.bfloat16).float() for k in fb.MASK_LAYERS}
    assert torch.equal(fb.mask_bits(rounded), bits)
    h2 = acts["h2"] > 0  # layer 1's bytes: 2,048 from 2,048 (thread t at 16 t)
    for block, t, word, bit in ((0, 0, 0, 0), (1, 37, 2, 13), (0, 127, 3, 31)):
        w, lane = t // 32, t % 32
        j, e = 8 * word + bit // 4, bit % 4
        row = 64 * block + 16 * w + lane // 4 + 8 * (e >> 1)
        col = 8 * j + 2 * (lane % 4) + (e & 1)
        off = 2048 + 16 * t + 4 * word
        value = int.from_bytes(bytes(bits[block, off: off + 4].tolist()), "little")
        assert (value >> bit) & 1 == int(h2[row, col])


@pytest.mark.parametrize("model", ["lego", "random"])
def test_backward_stream_gives_back_every_matrix(lego, model):
    """wpack_bwd unpacks to every layer matrix of wbuf exactly, and holds
    element (k, n) of part (rows r0.. of a [K, N] layer) at
    (n // 8) * rows * 8 + (k - r0) * 8 + n % 8 from the part's start: W^T in
    wgmma's K-major layout, as the chain reads it."""
    kp = fused_mlp.repack_params(_model(lego, model))
    wb = kp["wpack_bwd"]
    assert wb.shape == (fused_mlp.WPACK_SIZE,) and wb.dtype == torch.bfloat16
    want = fused_mlp.unpack_weight_stream(kp["wpack"])
    got = fused_mlp.unpack_bwd_stream(wb)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
    off = 0
    mats = fused_mlp._stream_matrices(kp["wbuf"])
    for i, r0, rows in fused_mlp.BWD_STREAM:
        n_out = fused_mlp.STREAM_LAYERS[i][1]
        for k, n in ((r0, 0), (r0 + rows - 1, n_out - 1), (r0 + rows // 2, 9)):
            assert wb[off + (n // 8) * rows * 8 + (k - r0) * 8 + n % 8] == mats[i][k, n]
        off += rows * n_out
    assert off == fused_mlp.WPACK_SIZE
    assert torch.equal(fused_mlp.pack_bwd_stream(kp["wbuf"]), wb)


@pytest.mark.parametrize("model", ["lego", "random"])
def test_repack_keeps_the_forward_buffers(lego, model):
    """Adding wpack_bwd leaves wbuf, bbuf and wpack as the forward reads them."""
    kp = fused_mlp.repack_params(_model(lego, model))
    wbuf, bbuf = fused_mlp._pack_kernel_buffers(kp)
    assert torch.equal(kp["wbuf"], wbuf) and torch.equal(kp["bbuf"], bbuf)
    assert torch.equal(kp["wpack"], fused_mlp.pack_weight_stream(wbuf))
    assert kp["wbuf"].shape == (fused_mlp.WBUF_SIZE,)
    assert kp["bbuf"].shape == (fused_mlp.BBUF_SIZE,)


def test_the_shared_header_matches_the_wrappers_layout():
    """csrc/fused_mlp.cuh, the layout that B1, B2 and the wgmma forward
    share, agrees with the wrappers: the buffer sizes, the weight stream's
    length, the stash's width and the column of every activation the plain
    backward reads from it (on the card the libraries report their sizes
    when loaded; here the header itself is read)."""
    import re

    from nerf_tpu_torch.ops import build

    consts = {}
    header = (build.CSRC / "fused_mlp.cuh").read_text()
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", header):
        consts[name] = eval(expr, {"__builtins__": {}}, dict(consts))
    wgmma = (build.CSRC / "fused_mlp_wgmma.cuh").read_text()
    wpack = consts[re.search(r"constexpr int WPACK_SIZE = (\w+);", wgmma).group(1)]
    W, EX = consts["W"], consts["EX"]

    def s_h(layer):  # the header's s_h: the stash column of h_{layer+1}
        return layer * W if layer < 4 else consts["S_EX"] + EX + (layer - 4) * W

    assert (consts["WBUF_SIZE"], consts["BBUF_SIZE"], wpack) == (
        fused_mlp.WBUF_SIZE, fused_mlp.BBUF_SIZE, fused_mlp.WPACK_SIZE)
    assert consts["SLD"] == STASH_WIDTH
    cols = {f"h{layer + 1}": s_h(layer) for layer in range(8)}
    cols.update(feat=consts["S_FEAT"], v=consts["S_V"])
    assert cols == fb.STASH_COLS


def test_splits_fill_one_wave():
    """21 weight-gradient blocks per range: 6 ranges are 126 blocks, one wave
    on 132 SMs; small launches take no more ranges than 64-point blocks."""
    assert fb.splits_for(196_608) == (6, 128)
    assert fb.splits_for(65_536) == (6, 128)
    assert fb.splits_for(128) == (2, 2)
    assert fb.splits_for(0) == (1, 1)


@pytest.mark.parametrize("name", ["kernel", "no_stash", "no_gbuf", "stash_masks", "splits64"])
def test_bwd_variants_apply_to_the_kernel_source(name):
    """Every variant of tools/bwd_variants.py still finds the lines it
    replaces in the backward's sources (the tool raises when one does not)."""
    from nerf_tpu_torch.tools import bwd_variants

    assert set(bwd_variants.VARIANTS) == {"kernel", "no_stash", "no_gbuf", "stash_masks",
                                          "splits64"}
    out = bwd_variants.variant_sources(name)
    assert set(out) == set(bwd_variants.VARIANTS[name])
    for fname, text in out.items():
        src = (bwd_variants.build.CSRC / fname).read_text()
        assert text != src, fname
        assert (len(text) > len(src)) == (name == "stash_masks"), fname  # the others remove lines
