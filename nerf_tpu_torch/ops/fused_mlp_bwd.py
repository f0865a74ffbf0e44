"""Backward of the fused NeRF-MLP; counterpart of ``nerf_tpu/ops/fused_mlp_bwd.py``.

``fused_nerf_bwd`` launches the CUDA kernels of ``csrc/fused_mlp_bwd.cu``
(the port of the Pallas ``_bwd_kernel``, ``nerf_tpu/ops/fused_mlp_bwd.py:43``)
on CUDA tensors and runs ``fused_nerf_bwd_plain``, the same math in plain
PyTorch, on CPU tensors. Both recompute the forward of
``fused_nerf_eval_plain`` and return the gradients of every kernel weight
and bias (``_GRAD_KEYS``, f32, in the ``repack_params`` layout, summed over
the points) and of the points and directions.

Where each rounds: every product takes its operands rounded to the weights'
dtype (the activations the forward multiplied; each layer's pre-activation
gradient G) and sums in ``accumulate``; the bias gradients sum those G; the
sigma and rgb heads take the upstream gradient unrounded. With float32
weights nothing rounds, which is the Pallas kernel's math (f32 activations,
f32 gradients).

``kgrads_to_param_grads`` maps the kernel layout back to the standard MLP
tree (weights [in, out]); it only permutes and concatenates, so it is exact.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span
from . import build
from .fused_mlp import BBUF_SIZE, WBUF_SIZE, WPACK_SIZE, _EMB_PAD, _emb_perm, _phases

# the kernel weights of nerf_tpu's _KPARAM_KEYS, in its order, without sx/sd
_GRAD_KEYS = (
    "w0x", "w0s", "w0c", "b0",
    "w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4",
    "w5x", "w5s", "w5c", "w5h", "b5",
    "w6", "b6", "w7", "b7",
    "wa", "ba", "wf", "bf",
    "wvx", "wvs", "wvc", "wvf", "bv",
    "wr", "br",
)
_TILE = 128  # the kernels' point tile; the wrapper pads P to a multiple of it
SLAB_ROWS = 64  # points in a block of the slab layout
WGRAD_SPLITS = 6  # point ranges of the weight gradients: 21 blocks each, one wave on 132 SMs
HEAD_SPLITS = 128  # point ranges of the heads' gradients (scalar work)


def splits_for(n_points: int):
    """(weight-gradient ranges, head ranges) for n_points: at most
    WGRAD_SPLITS and HEAD_SPLITS, and no more than the 64-point blocks
    there are."""
    blocks = n_points // SLAB_ROWS
    return max(1, min(WGRAD_SPLITS, blocks)), max(1, min(HEAD_SPLITS, blocks))


def pack_slabs(t: torch.Tensor) -> torch.Tensor:
    """[P, C] -> the kernels' slab layout [ceil(P/64), C/8, 64, 8]: 8 columns
    of 64 points a slab, zero rows past P."""
    p, c = t.shape
    pad = (-p) % SLAB_ROWS
    if pad:
        t = torch.cat([t, t.new_zeros(pad, c)])
    return t.reshape(-1, SLAB_ROWS, c // 8, 8).transpose(1, 2).contiguous()


def unpack_slabs(s: torch.Tensor, n_points: int) -> torch.Tensor:
    """The inverse of ``pack_slabs``: [B, C/8, 64, 8] -> [n_points, C]."""
    b, c8 = s.shape[:2]
    return s.transpose(1, 2).reshape(b * SLAB_ROWS, c8 * 8)[:n_points]


# the ReLU masks the kernels' forward writes as bits, per 64-point block:
# h1..h8 (256 columns each), then v (128), 16 (v: 8) bytes for each of the
# 128 threads of a consumer warpgroup (csrc/fused_mlp_wgmma.cuh)
MASK_LAYERS = ("h1", "h2", "h3", "h4", "h5", "h6", "h7", "h8", "v")
MASK_BLOCK_BYTES = 8 * 128 * 16 + 128 * 8


@functools.lru_cache(maxsize=None)
def _fragment_index(width: int):
    """(rows, cols) [128, width/64, 32]: the element of bit b of word i of
    thread t. Thread t = 32 w + lane holds rows 16 w + lane/4 (+8) at columns
    8 j + 2 (lane % 4) (+1); bit 4 (j % 8) + e of word j / 8 is its element
    e: (row, col), (row, col + 1), (row + 8, col), (row + 8, col + 1)."""
    t = np.arange(128)[:, None, None]
    i = np.arange(width // 64)[None, :, None]
    b = np.arange(32)[None, None, :]
    j, e = 8 * i + b // 4, b % 4
    rows = 16 * (t // 32) + (t % 32) // 4 + 8 * (e >> 1)
    cols = 8 * j + 2 * (t % 4) + (e & 1)
    return torch.as_tensor(np.broadcast_to(rows, cols.shape).copy()), torch.as_tensor(cols)


def mask_bits(acts: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernels' mask bits of ``acts`` (h1..h8 and v, [P, width], P a
    multiple of 64): uint8 [P/64, MASK_BLOCK_BYTES], bit set where > 0."""
    out = []
    for k in MASK_LAYERS:
        h = acts[k] > 0
        rows, cols = (x.to(h.device) for x in _fragment_index(h.shape[1]))
        bits = h.reshape(-1, SLAB_ROWS, h.shape[1])[:, rows, cols].long()  # [B, 128, nw, 32]
        words = (bits << torch.arange(32, device=h.device)).sum(-1)
        by = torch.stack([(words >> (8 * k)) & 255 for k in range(4)], -1)
        out.append(by.reshape(h.shape[0] // SLAB_ROWS, -1).to(torch.uint8))
    return torch.cat(out, 1)


def unpack_mask_bits(masks: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The inverse of ``mask_bits``: {h1..h8, v: bool [P, width]}."""
    out, off = {}, 0
    for k in MASK_LAYERS:
        width = 128 if k == "v" else 256
        n = 128 * width // 16
        by = masks[:, off: off + n].long().reshape(masks.shape[0], 128, width // 64, 4)
        off += n
        words = sum(by[..., i] << (8 * i) for i in range(4))
        bits = (words[..., None] >> torch.arange(32, device=masks.device)) & 1
        rows, cols = (x.to(masks.device) for x in _fragment_index(width))
        h = torch.zeros((masks.shape[0], SLAB_ROWS, width), dtype=torch.bool,
                        device=masks.device)
        h[:, rows, cols] = bits.bool()
        out[k] = h.reshape(-1, width)
    return out


def plain_activations(kp: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
                      accumulate: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The forward of ``fused_nerf_eval_plain`` with every activation the
    backward reads: x, sa, ca, h1..h8 (post-ReLU), feat, d, sb, cb, v."""
    def dot(a, w):
        return a.to(w.dtype).to(accumulate) @ w.to(accumulate)

    relu = lambda v: torch.clamp_min(v, 0.0)  # noqa: E731
    x = pts.float()
    a = _phases(x, kp["sx"])
    sa, ca = torch.sin(a), torch.cos(a)
    hs = [relu(dot(x, kp["w0x"]) + dot(sa, kp["w0s"]) + dot(ca, kp["w0c"]) + kp["b0"])]
    for i in (1, 2, 3, 4):
        hs.append(relu(dot(hs[-1], kp[f"w{i}"]) + kp[f"b{i}"]))
    hs.append(relu(dot(x, kp["w5x"]) + dot(sa, kp["w5s"]) + dot(ca, kp["w5c"])
                   + dot(hs[-1], kp["w5h"]) + kp["b5"]))
    for i in (6, 7):
        hs.append(relu(dot(hs[-1], kp[f"w{i}"]) + kp[f"b{i}"]))
    acts = {f"h{i + 1}": h for i, h in enumerate(hs)}
    acts["feat"] = dot(hs[-1], kp["wf"]) + kp["bf"]
    d = dirs.float()
    b = _phases(d, kp["sd"])
    sb, cb = torch.sin(b), torch.cos(b)
    acts["v"] = relu(dot(acts["feat"], kp["wvf"]) + dot(d, kp["wvx"]) + dot(sb, kp["wvs"])
                     + dot(cb, kp["wvc"]) + kp["bv"])
    acts.update(x=x, sa=sa, ca=ca, d=d, sb=sb, cb=cb)
    return acts


# columns of the CUDA kernel's activation stash (csrc/fused_mlp.cuh, SLD = 2528)
STASH_COLS = {"h1": 0, "h2": 256, "h3": 512, "h4": 768, "h5": 1088, "h6": 1344, "h7": 1600,
              "h8": 1856, "feat": 2112, "v": 2400}


def stash_activations(kp: Dict[str, torch.Tensor], stash: torch.Tensor, pts: torch.Tensor,
                      dirs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``plain_activations``' dict read from the CUDA kernel's stash [P, 2528]
    (its bf16 activations; the phases again in float32), so that the plain
    backward can run on the kernel's own forward."""
    acts = {}
    for k, c in STASH_COLS.items():
        width = kp["b1"].shape[1] if k.startswith("h") or k == "feat" else kp["bv"].shape[1]
        acts[k] = stash[:, c: c + width].float()
    x, d = pts.float(), dirs.float()
    a, b = _phases(x, kp["sx"]), _phases(d, kp["sd"])
    acts.update(x=x, sa=torch.sin(a), ca=torch.cos(a), d=d, sb=torch.sin(b), cb=torch.cos(b))
    return acts


def fused_nerf_bwd_plain(kp: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
                         g: torch.Tensor, accumulate: torch.dtype = torch.float32,
                         input_grads: bool = True, tf32: bool = False
                         ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor],
                                    Optional[torch.Tensor]]:
    """The kernels' math in plain PyTorch. pts, dirs [P, 3], g [P, 4] (the
    gradient of raw [P, 4]) -> ({key: f32 grad}, dpts, ddirs [P, 3] or None).
    ``accumulate`` float64 sums every product in another order, which shows
    how far bf16 rounding alone moves the gradients. ``tf32`` (float32
    weights) forms the weight gradients as the float32 kernel's tensor cores
    do, ``dw_3xtf32_plain``."""
    return backward_from_activations(kp, plain_activations(kp, pts, dirs, accumulate), g,
                                     accumulate, input_grads, tf32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (float32) = hi + lo to about 2^-22 of |x|: hi is x rounded to TF32
    (10 mantissa bits, to nearest, ties away from zero: ``cvt.rna.tf32.f32``),
    lo is x - hi (exact in float32) rounded the same way."""
    def rna(v):  # add half of the 13 dropped bits to the magnitude, then drop them
        return ((v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def dw_3xtf32_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x [P, K]^T @ g [P, N] -> float32 [K, N] as the float32 kernel's
    weight gradients form it (3xTF32): hi_x hi_g + hi_x lo_g + lo_x hi_g,
    each product of two TF32 values exact and summed here in float64 (the
    card sums in float32)."""
    xh, xl = (t.double() for t in tf32_split(x))
    gh, gl = (t.double() for t in tf32_split(g))
    return (xh.T @ gh + xh.T @ gl + xl.T @ gh).float()


def backward_from_activations(kp: Dict[str, torch.Tensor], acts: Dict[str, torch.Tensor],
                              g: torch.Tensor, accumulate: torch.dtype = torch.float32,
                              input_grads: bool = True, tf32: bool = False):
    """The backward half of ``fused_nerf_bwd_plain``, given the forward's
    activations (``plain_activations`` or ``stash_activations``)."""
    wdt = kp["w1"].dtype

    def rnd(a):  # an operand as the tensor cores see it
        return a.to(wdt).to(accumulate)

    def dx(gr, w):  # gr [P, N] @ w[K, N]^T -> [P, K]
        return gr @ w.to(accumulate).T

    def dw(x, gr):  # x[P, K]^T @ gr[P, N] -> [K, N]
        if tf32:
            return dw_3xtf32_plain(x, gr)
        return (rnd(x).T @ gr).float()

    def colsum(gr):
        return gr.sum(0, keepdim=True).float()

    x, sa, ca, d, sb, cb = (acts[k] for k in ("x", "sa", "ca", "d", "sb", "cb"))
    h1, h2, h3, h4, h5, h6, h7, h8 = (acts[f"h{i}"] for i in range(1, 9))
    feat, v = acts["feat"], acts["v"]

    g = g.to(accumulate)
    drgb, dsig = g[:, :3], g[:, 3:4]
    out: Dict[str, torch.Tensor] = {}
    out["wr"] = dw(v, drgb)
    out["br"] = colsum(drgb)
    gv = rnd((drgb @ kp["wr"].to(accumulate).T) * (v > 0))
    for k, inp in (("wvf", feat), ("wvx", d), ("wvs", sb), ("wvc", cb)):
        out[k] = dw(inp, gv)
    out["bv"] = colsum(gv)
    gf = rnd(dx(gv, kp["wvf"]))
    out["wf"], out["bf"] = dw(h8, gf), colsum(gf)
    out["wa"], out["ba"] = dw(h8, dsig), colsum(dsig)
    gl = rnd((dx(gf, kp["wf"]) + dsig @ kp["wa"].to(accumulate).T) * (h8 > 0))  # G_7
    for i, h_in in ((7, h7), (6, h6)):
        out[f"w{i}"], out[f"b{i}"] = dw(h_in, gl), colsum(gl)
        gl = rnd(dx(gl, kp[f"w{i}"]) * (h_in > 0))
    # gl is G_5, the skip layer's
    for k, inp in (("w5x", x), ("w5s", sa), ("w5c", ca), ("w5h", h5)):
        out[k] = dw(inp, gl)
    out["b5"] = colsum(gl)
    g5 = gl
    gl = rnd(dx(g5, kp["w5h"]) * (h5 > 0))  # G_4
    for i, h_in in ((4, h4), (3, h3), (2, h2), (1, h1)):
        out[f"w{i}"], out[f"b{i}"] = dw(h_in, gl), colsum(gl)
        gl = rnd(dx(gl, kp[f"w{i}"]) * (h_in > 0))
    for k, inp in (("w0x", x), ("w0s", sa), ("w0c", ca)):
        out[k] = dw(inp, gl)
    out["b0"] = colsum(gl)
    kgrads = {k: out[k] for k in _GRAD_KEYS}
    if not input_grads:
        return kgrads, None, None
    g0 = gl
    da = (ca * (dx(g0, kp["w0s"]) + dx(g5, kp["w5s"]))
          - sa * (dx(g0, kp["w0c"]) + dx(g5, kp["w5c"])))
    dpts = dx(g0, kp["w0x"]) + dx(g5, kp["w5x"]) + _phases_t(da, kp["sx"])
    db = cb * dx(gv, kp["wvs"]) - sb * dx(gv, kp["wvc"])
    ddirs = dx(gv, kp["wvx"]) + _phases_t(db, kp["sd"])
    return kgrads, dpts.float(), ddirs.float()


# Rounding margin of a ReLU pre-activation z = sum_i w_i h_i + b in float32:
# KNIFE_EDGE_C * 2^-24 * (sum_i |w_i h_i| + |b|). A blocked float32 dot
# product of K <= 319 terms (layer 5) errs by about sqrt(K) * 2^-24 of that
# sum (<= 18 units; K * 2^-24 at worst), and the inputs carry in their own
# rounding from up to eight layers below and from sin/cos of the exact
# float32 phases (a few units each, of the same magnitudes).
KNIFE_EDGE_C = 64.0


def relu_margins(kp: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor):
    """[(layer, z, s)] for every ReLU layer of the plain forward (pts layers
    0-7 and the view layer "v"), in float64 from the float32 weights ``kp``
    and the float32 phases: z the pre-activations [P, units], s the sums of
    |w_i h_i| + |b|."""
    f64 = torch.float64
    w = {k: v.to(f64) for k, v in kp.items() if k != "wbuf_t"}
    x, dd = pts.to(f64), dirs.to(f64)
    a = _phases(pts.float(), kp["sx"]).to(f64)
    b = _phases(dirs.float(), kp["sd"]).to(f64)

    def lin(terms, bias):
        z = sum(h @ w[k] for h, k in terms) + w[bias]
        s = sum(h.abs() @ w[k].abs() for h, k in terms) + w[bias].abs()
        return z, s

    enc = [(x, "w0x"), (a.sin(), "w0s"), (a.cos(), "w0c")]
    out = [(0, *lin(enc, "b0"))]
    for i in (1, 2, 3, 4):
        out.append((i, *lin([(out[-1][1].clamp_min(0), f"w{i}")], f"b{i}")))
    enc5 = [(h, k.replace("0", "5")) for h, k in enc]
    out.append((5, *lin(enc5 + [(out[-1][1].clamp_min(0), "w5h")], "b5")))
    for i in (6, 7):
        out.append((i, *lin([(out[-1][1].clamp_min(0), f"w{i}")], f"b{i}")))
    feat = out[-1][1].clamp_min(0) @ w["wf"] + w["bf"]
    view = [(feat, "wvf"), (dd, "wvx"), (b.sin(), "wvs"), (b.cos(), "wvc")]
    out.append(("v", *lin(view, "bv")))
    return out


def knife_edge_points(kp: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
                      c: float = KNIFE_EDGE_C) -> torch.Tensor:
    """bool [P]: points with a ReLU unit within c * 2^-24 * s of zero
    (``relu_margins``): two correct float32 forwards may decide such a unit
    either way, and one flip moves a whole gradient leaf, so a comparison of
    two float32 backwards zeroes these points' cotangents on both sides."""
    hit = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    for _, z, s in relu_margins(kp, pts, dirs):
        hit |= (z.abs() < c * 2.0 ** -24 * s).any(dim=1)
    return hit


def _phases_t(da: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """da @ S^T as exact sums of scaled terms (S: one power of two per column)."""
    d = s.shape[0]
    scale = s.sum(0).to(da.dtype)
    return (da * scale).reshape(da.shape[0], -1, d).sum(1)


def _grad_layout(kp: Dict[str, torch.Tensor]):
    """[(key, offset, rows, cols)] of each gradient in the kernel's flat
    output: the weights in wbuf order, then the biases in bbuf order from
    WBUF_SIZE on; the shapes are kp's."""
    out, off = [], 0

    def emb(keys):
        nonlocal off
        for k in keys:
            r, c = kp[k].shape
            out.append((k, off, r, c))
            off += r * c
        rows = sum(kp[k].shape[0] for k in keys)
        off += ((-rows) % _EMB_PAD) * kp[keys[0]].shape[1]

    def mat(k):
        nonlocal off
        r, c = kp[k].shape
        out.append((k, off, r, c))
        off += r * c

    emb(("w0x", "w0s", "w0c"))
    for k in ("w1", "w2", "w3", "w4"):
        mat(k)
    emb(("w5x", "w5s", "w5c"))
    for k in ("w5h", "w6", "w7", "wf", "wvf"):
        mat(k)
    emb(("wvx", "wvs", "wvc"))
    mat("wa")
    mat("wr")
    if off != WBUF_SIZE:
        raise ValueError(f"kernel weights take {off} entries, not {WBUF_SIZE}")
    for k in ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7", "bf", "bv", "ba", "br"):
        mat(k)
    return out


def fused_nerf_bwd(kp: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
                   g: torch.Tensor, input_grads: bool = True
                   ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """``fused_nerf_bwd_plain``'s function: the CUDA kernels for CUDA tensors,
    the plain version for CPU tensors. pts, dirs [P, 3], g [P, 4] float32.
    bf16 weights take ``csrc/fused_mlp_bwd.cu`` (scratch ~10 KB a point),
    float32 weights ``csrc/fused_mlp_bwd_f32.cu`` (``launch_f32``: ~19.8 KB
    a point of at most ``F32_CHUNK`` points); the scratch lives until the
    call returns."""
    if pts.device.type == "cpu":
        return fused_nerf_bwd_plain(kp, pts, dirs, g, input_grads=input_grads)
    if kp["wbuf"].dtype == torch.float32:
        out = launch_f32(kp, pts, dirs, g, input_grads)
        fused_nerf_bwd_f32.launches += 1
    else:
        out = launch_full(kp, pts, dirs, g, input_grads, unpack=False)
        fused_nerf_bwd.launches += 1
    return out["kgrads"], out["dpts"], out["ddirs"]


def fused_nerf_bwd_f32(kp: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
                       g: torch.Tensor, input_grads: bool = True):
    """``fused_nerf_bwd`` for float32 weights (B2-f32,
    ``csrc/fused_mlp_bwd_f32.cu``; true float32 products on the CUDA cores).
    ``fused_nerf_bwd`` dispatches here on ``kp["wbuf"].dtype``;
    ``fused_nerf_bwd_f32.launches`` counts its launches."""
    if pts.device.type != "cpu" and kp["wbuf"].dtype != torch.float32:
        raise ValueError(f"wbuf: need float32 weights, got {kp['wbuf'].dtype}")
    return fused_nerf_bwd(kp, pts, dirs, g, input_grads)


fused_nerf_bwd_f32.launches = 0


def _check_inputs(kp, pts, dirs, g, dtype=torch.bfloat16) -> int:
    P = pts.shape[0]
    if P > build.MAX_LAUNCH_ROWS:
        raise ValueError(f"{P} points in one call; split it into calls of at most "
                         f"{build.MAX_LAUNCH_ROWS}")
    build.check_cuda("pts", pts, torch.float32, (P, 3))
    build.check_cuda("dirs", dirs, torch.float32, (P, 3))
    build.check_cuda("g", g, torch.float32, (P, 4), align=16)
    build.check_cuda("wbuf", kp["wbuf"], dtype, (WBUF_SIZE,), align=32)
    build.check_cuda("bbuf", kp["bbuf"], torch.float32, (BBUF_SIZE,))
    return P


def _pad(tile, *ts):
    """The tensors padded with zero rows to a multiple of tile (zero upstream
    gradients: padded points add nothing)."""
    pad = (-ts[0].shape[0]) % tile
    if not pad:
        return ts
    return tuple(torch.cat([t, t.new_zeros(pad, t.shape[1])]) for t in ts)


def _grads_of(flat: torch.Tensor, kp) -> Dict[str, torch.Tensor]:
    kgrads = {k: flat[off: off + r * c].view(r, c) for k, off, r, c in _grad_layout(kp)}
    return {k: kgrads[k] for k in _GRAD_KEYS}


PHASES_ALL = 31  # the launches of csrc/fused_mlp_bwd.cu: forward, chain, dW, heads, reduce


def launch(kp: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
           g: torch.Tensor, input_grads: bool = True):
    """The kernels on CUDA tensors (not counted: ``fused_nerf_bwd`` counts its
    launches). Returns (kgrads, dpts, ddirs, stash): the stash [P, 2528]
    holds the recomputed forward's bf16 activations, for checks."""
    out = launch_full(kp, pts, dirs, g, input_grads)
    return out["kgrads"], out["dpts"], out["ddirs"], out["stash"]


def launch_full(kp: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
                g: torch.Tensor, input_grads: bool = True, splits=None, unpack: bool = True):
    """``launch`` with everything the kernels wrote, for checks and timing:
    kgrads, dpts, ddirs, stash ([P, 2528], unpacked), raw (the recomputed
    forward's [P, 4]), masks (uint8 [P'/64, MASK_BLOCK_BYTES]), the slab
    tensors stash_slabs and gbuf_slabs, args, the launch's arguments
    (``_lib()[0].launch_fused_nerf_bwd(*args)`` launches it again while
    ``keep``, the tensors it reads and writes, lives; its last int but one
    selects the launches, ``PHASES_ALL`` all five); P' is P padded to the
    128-point tile. ``splits`` overrides (dW ranges, head ranges). With
    ``unpack`` False (the train path) "stash" is None: unpacking copies the
    whole stash."""
    P = _check_inputs(kp, pts, dirs, g)
    for k in ("wpack", "wpack_bwd"):
        build.check_cuda(k, kp[k], torch.bfloat16, (WPACK_SIZE,), align=16)
    lib, sld, gld, pst, mblock, head_ld = _lib()
    pts, dirs, g = _pad(_TILE, pts, dirs, g)
    n = pts.shape[0]
    splits, head_splits = splits or splits_for(n)
    dev = pts.device
    blocks = n // SLAB_ROWS
    stash = torch.empty((blocks, sld // 8, SLAB_ROWS, 8), dtype=torch.bfloat16, device=dev)
    gbuf = torch.empty((blocks, gld // 8, SLAB_ROWS, 8), dtype=torch.bfloat16, device=dev)
    masks = torch.empty((blocks, mblock), dtype=torch.uint8, device=dev)
    partial = torch.empty((splits, pst), dtype=torch.float32, device=dev)
    hpartial = torch.empty((head_splits, head_ld), dtype=torch.float32, device=dev)
    flat = torch.empty(WBUF_SIZE + BBUF_SIZE, dtype=torch.float32, device=dev)
    raw = torch.empty((n, 4), dtype=torch.float32, device=dev)
    dpts = torch.empty((n, 3), dtype=torch.float32, device=dev) if input_grads else None
    ddirs = torch.empty((n, 3), dtype=torch.float32, device=dev) if input_grads else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = [pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), kp["wpack"].data_ptr(),
            kp["wpack_bwd"].data_ptr(), kp["wbuf"].data_ptr(), kp["bbuf"].data_ptr(),
            stash.data_ptr(), gbuf.data_ptr(), masks.data_ptr(), partial.data_ptr(),
            hpartial.data_ptr(), flat.data_ptr(), ptr(dpts), ptr(ddirs), raw.data_ptr(), n,
            splits, head_splits,
            int(input_grads), PHASES_ALL, torch.cuda.current_stream(dev).cuda_stream]
    rc = lib.launch_fused_nerf_bwd(*args)
    if rc != 0:
        raise RuntimeError(f"fused_nerf_bwd kernel launch failed: CUDA error {rc}")
    if input_grads:
        dpts, ddirs = dpts[:P], ddirs[:P]
    # every tensor the launch reads or writes stays referenced with its args
    keep = (pts, dirs, g, stash, gbuf, masks, partial, hpartial, flat, raw, dpts, ddirs)
    return {"kgrads": _grads_of(flat, kp), "dpts": dpts, "ddirs": ddirs,
            "stash": unpack_slabs(stash, P) if unpack else None, "raw": raw[:P], "masks": masks,
            "stash_slabs": stash, "gbuf_slabs": gbuf, "args": args, "keep": keep}


fused_nerf_bwd.launches = 0


def wgrad_product(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x [64, 64]^T @ g [64, 256] (bf16 CUDA tensors, 64 points a row) ->
    float32 [64, 256], through the weight-gradient kernel's own slab layout,
    MN-major descriptors and wgmma products: the check of those parts alone,
    for the GPU tests and ``chip_smoke.py``."""
    build.check_cuda("x", x, torch.bfloat16, (SLAB_ROWS, 64))
    build.check_cuda("g", g, torch.bfloat16, (SLAB_ROWS, 256))
    xs, gs = pack_slabs(x), pack_slabs(g)
    out = torch.empty((64, 256), dtype=torch.float32, device=x.device)
    rc = _lib()[0].launch_wgrad_test(xs.data_ptr(), gs.data_ptr(), out.data_ptr(),
                                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wgrad test launch failed: CUDA error {rc}")
    torch.cuda.current_stream(x.device).synchronize()
    return out


def bind(lib: ctypes.CDLL):
    """(lib, SLD, GLD, PST, mask block bytes, heads' partial row) of a loaded
    fused_mlp_bwd library, its functions' argument types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_fused_nerf_bwd.argtypes = [p] * 16 + [i] * 5 + [p]
    lib.launch_wgrad_test.argtypes = [p] * 4
    for fn in (lib.launch_fused_nerf_bwd, lib.launch_wgrad_test):
        fn.restype = ctypes.c_int
    lib.fused_nerf_bwd_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
    lib.fused_nerf_bwd_sizes.restype = None
    sizes = [ctypes.c_int() for _ in range(5)]
    lib.fused_nerf_bwd_sizes(*(ctypes.byref(v) for v in sizes))
    sld, gld, pst, mblock, head_ld = (v.value for v in sizes)
    if mblock != MASK_BLOCK_BYTES:
        raise RuntimeError(f"fused_mlp_bwd.cu mask block {mblock} differs from "
                           f"{MASK_BLOCK_BYTES}")
    return lib, sld, gld, pst, mblock, head_ld


@functools.cache
def _lib():
    return bind(build.load("fused_mlp_bwd"))


# The float32 backward (csrc/fused_mlp_bwd_f32.cu): its scratch is ~19.8 KB
# a point (a float32 stash of the activations and gbuf of the layer
# gradients), so it runs on chunks of at most F32_CHUNK points (5.2 GB). The
# weight gradients of a chunk are summed over F32_SPLITS point ranges (at
# most one per F32_MIN_TILES_PER_SPLIT tiles of 64 points), then added to
# the chunks' before. A range's units (dw_units) hold the work of 36 full
# units; 33 ranges ran the lego fine batch's weight gradients fastest on an
# H100 (tools/bwd_f32_variants.py --splits: 2.64 ms, against 3.01-3.03 with
# 11 and 2.72-2.77 with 16, 22, 44 and 66).
F32_TILE = 64
F32_CHUNK = 1 << 18
F32_SPLITS, F32_MIN_TILES_PER_SPLIT = 33, 8
F32_PHASES_ALL = 15  # forward + stash, chain, weight gradients (3xTF32), reduce


def f32_splits_for(n_points: int) -> int:
    return max(1, min(F32_SPLITS, (n_points // F32_TILE) // F32_MIN_TILES_PER_SPLIT))


# Layout of the float32 kernels' buffers (csrc/fused_mlp_f32.cuh,
# csrc/fused_mlp_bwd_f32.cu), in floats: stash and gbuf columns, wbuf and
# bbuf offsets of the flat gradient (biases from WBUF_SIZE on).
_W, _VW, _EX, _ED = 256, 128, 64, 32
_S_X, _S_FEAT, _S_D = 0, _EX + 8 * _W, _EX + 9 * _W
_S_V = _S_D + _ED
_G_F, _G_V = 8 * _W, 9 * _W
_G_IN = _G_V + _VW
_OFF_L5 = _EX * _W + 4 * _W * _W
_OFF_LF = _OFF_L5 + (_EX + _W) * _W + 2 * _W * _W
_OFF_LV = _OFF_LF + _W * _W
_OFF_WA = _OFF_LV + (_W + _ED) * _VW
_OFF_WR = _OFF_WA + _W
_OFF_BF, _OFF_BV = 8 * _W, 9 * _W
_OFF_BA = _OFF_BV + _VW


def _s_h(i):
    return _EX + (i - 1) * _W


def _off_layer(i):  # trunk layers 1-4, 6, 7
    if i <= 4:
        return _EX * _W + (i - 1) * _W * _W
    return _OFF_L5 + (_EX + _W) * _W + (i - 6) * _W * _W


# a row of the unit table, as csrc/fused_mlp_bwd_f32.cu's DwUnit
DW_UNIT_FIELDS = ("kind", "xcol", "xlines", "gcol", "glines", "x0", "x1", "g0", "g1", "out0",
                  "out1", "ld", "rows", "nsplit", "bias")
DW_PRODUCTS, DW_HEADS, DW_VIEW_RGB, DW_KSPLIT = 0, 1, 2, 3


def dw_units(fold_bias: bool = True) -> np.ndarray:
    """The float32 weight gradients' work units, int32 [units, 15]. A unit
    holds two 64-row x 128-column product slices, one per consumer
    warpgroup, of one gradient matrix: the 128 x 128 quarters of each
    256-wide layer and the view layer's 128-row feature slices. Layer 0's
    and the skip layer's 64 encoding rows, in 128-column halves, and the view
    layer's 32 direction rows are one slice each, their points shared by the
    two warpgroups (DW_KSPLIT). A layer's bias gradient (the column sums of
    its G) rides on the units whose rows start at 0. wr, and wa with ba and
    br, are two small units on the CUDA cores. With ``fold_bias`` False (a
    variant for comparison) the biases are units of their own."""
    wb = WBUF_SIZE
    rows = []

    def unit(kind, xcol, xlines, gcol, glines, x, g, out, ld, nrows, nsplit, bias):
        if not fold_bias and kind in (DW_PRODUCTS, DW_KSPLIT):
            bias = -1
        rows.append([kind, xcol, xlines, gcol, glines, *x, *g, *out, ld, nrows, nsplit, bias])

    def enc64(gcol, out, bias):  # 64 encoding rows x 256 columns, in halves
        for n0 in (0, 128):
            unit(DW_KSPLIT, _S_X, 64, gcol + n0, 128, (0, 0), (0, 0), (out + n0, out + n0), _W,
                 64, 128, bias + n0)

    def x128(xcol, gcol, out, n, bias):  # 128-row slices of a K x n matrix, 128 columns each
        for m0 in (0, 128):
            for n0 in range(0, n, 128):
                o = out + m0 * n + n0
                unit(DW_PRODUCTS, xcol + m0, 128, gcol + n0, 128, (0, 64), (0, 0),
                     (o, o + 64 * n), n, 64, 128, bias + n0 if bias >= 0 and m0 == 0 else -1)

    # the kernel launches the units in this order: the small ones last
    enc64(0, 0, wb)
    enc64(5 * _W, _OFF_L5, wb + 5 * _W)
    for i in (1, 2, 3, 4):
        x128(_s_h(i), i * _W, _off_layer(i), _W, wb + i * _W)
    x128(_s_h(5), 5 * _W, _OFF_L5 + _EX * _W, _W, -1)
    for i in (6, 7):
        x128(_s_h(i), i * _W, _off_layer(i), _W, wb + i * _W)
    x128(_s_h(8), _G_F, _OFF_LF, _W, wb + _OFF_BF)
    x128(_S_FEAT, _G_V, _OFF_LV, _VW, wb + _OFF_BV)
    unit(DW_KSPLIT, _S_D, 32, _G_V, _VW, (0, 0), (0, 0), (_OFF_LV + _W * _VW,) * 2, _VW, _ED,
         _VW, -1)
    unit(DW_VIEW_RGB, _S_V, _VW, _G_IN, 32, (-1, 0), (0, 0), (0, _OFF_WR), 0, 0, 0, -1)
    unit(DW_HEADS, _s_h(8), _W, _G_IN, 32, (-1, -1), (0, 0), (_OFF_WA, 0), 0, 0, 0,
         wb + _OFF_BA)
    if not fold_bias:  # 128 columns a unit, no product
        for gcol, boff in [(i * _W + n0, i * _W + n0) for i in range(8) for n0 in (0, 128)] + [
                (_G_F, _OFF_BF), (_G_F + 128, _OFF_BF + 128), (_G_V, _OFF_BV)]:
            rows.append([DW_PRODUCTS, _S_X, 32, gcol, 128, -1, -1, 0, 0, 0, 0, 1, 1, 128,
                         wb + boff])
    return np.asarray(rows, dtype=np.int32)


def dw_unit_entries(units: np.ndarray) -> np.ndarray:
    """Every entry of a partial row that the units write, once per write, as
    csrc/fused_mlp_bwd_f32.cu's dw_tf32_wgmma_kernel writes them."""
    out = []
    for row in units:
        u = dict(zip(DW_UNIT_FIELDS, (int(v) for v in row)))
        r, c = np.arange(u["rows"])[:, None], np.arange(128)[None, :]
        if u["kind"] == DW_HEADS:
            out += [u["out0"] + np.arange(_W), u["bias"] + np.arange(4)]
            continue
        if u["kind"] == DW_VIEW_RGB:
            out.append(u["out1"] + np.arange(3 * _VW))
            continue
        for w in ((0,) if u["kind"] == DW_KSPLIT else (0, 1)):
            if u[f"x{w}"] >= 0:
                out.append((u[f"out{w}"] + r * u["ld"] + c).ravel())
        if u["bias"] >= 0:
            out.append(u["bias"] + np.arange(u["nsplit"]))
    return np.concatenate(out)


@functools.lru_cache(maxsize=None)
def _units_arg(fold_bias: bool = True):
    """(the table as a C int array the launcher reads, its rows)."""
    units = dw_units(fold_bias)
    return (ctypes.c_int * units.size)(*units.ravel().tolist()), units.shape[0]


def launch_f32(kp: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
               g: torch.Tensor, input_grads: bool = True, chunk: int = F32_CHUNK,
               splits: Optional[int] = None, fold_bias: bool = True):
    """The float32 backward's launches on CUDA tensors (not counted:
    ``fused_nerf_bwd`` counts them). Returns {kgrads, dpts, ddirs, raw (the
    recomputed forward [P, 4]), stash_slabs ([tiles, SLD, 64] float32, of the
    last chunk), gbuf_slabs, args, keep}: ``_lib_f32()[0].launch_fused_nerf_bwd_f32(*args)``
    launches it again while ``keep`` lives; its last int but one selects the
    launches (``F32_PHASES_ALL`` all four). ``splits`` overrides the
    point ranges of the weight gradients, ``fold_bias`` False takes the
    units with the biases apart (comparisons only)."""
    P = _check_inputs(kp, pts, dirs, g, torch.float32)
    build.check_cuda("wbuf_t", kp["wbuf_t"], torch.float32, (WPACK_SIZE,), align=16)
    lib, sld, gld, pst = _lib_f32()
    pts, dirs, g = _pad(F32_TILE, pts, dirs, g)
    n = pts.shape[0]
    chunk = min(n, max(F32_TILE, chunk - chunk % F32_TILE))
    splits = splits or f32_splits_for(chunk)
    dev = pts.device
    tiles = chunk // F32_TILE
    stash = torch.empty((tiles, sld, F32_TILE), dtype=torch.float32, device=dev)
    gbuf = torch.empty((tiles, gld, F32_TILE), dtype=torch.float32, device=dev)
    partial = torch.empty((splits, pst), dtype=torch.float32, device=dev)
    flat = torch.empty(pst, dtype=torch.float32, device=dev)
    raw = torch.empty((n, 4), dtype=torch.float32, device=dev)
    dpts = torch.empty((n, 3), dtype=torch.float32, device=dev) if input_grads else None
    ddirs = torch.empty((n, 3), dtype=torch.float32, device=dev) if input_grads else None
    units, n_units = _units_arg(fold_bias)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = [pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), kp["wbuf"].data_ptr(),
            kp["bbuf"].data_ptr(), kp["wbuf_t"].data_ptr(), stash.data_ptr(), gbuf.data_ptr(),
            partial.data_ptr(), flat.data_ptr(), raw.data_ptr(), ptr(dpts), ptr(ddirs),
            ctypes.addressof(units), n, chunk, splits, n_units, int(input_grads), F32_PHASES_ALL,
            torch.cuda.current_stream(dev).cuda_stream]
    rc = lib.launch_fused_nerf_bwd_f32(*args)
    if rc != 0:
        raise RuntimeError(f"fused_nerf_bwd float32 kernel launch failed: CUDA error {rc}")
    keep = (pts, dirs, g, stash, gbuf, partial, flat, raw, dpts, ddirs, units)
    return {"kgrads": _grads_of(flat, kp), "dpts": dpts[:P] if input_grads else None,
            "ddirs": ddirs[:P] if input_grads else None, "raw": raw[:P],
            "stash_slabs": stash, "gbuf_slabs": gbuf, "args": args, "keep": keep}


@functools.cache
def _lib_f32():
    """(lib, SLD, GLD, PST) of the float32 backward's library."""
    return bind_f32(build.load("fused_mlp_bwd_f32"))


def bind_f32(lib: ctypes.CDLL):
    """(lib, SLD, GLD, PST) of a loaded fused_mlp_bwd_f32 library, its
    functions' argument types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_fused_nerf_bwd_f32.argtypes = [p] * 14 + [i] * 6 + [p]
    lib.launch_fused_nerf_bwd_f32.restype = ctypes.c_int
    lib.fused_nerf_bwd_f32_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    lib.fused_nerf_bwd_f32_sizes.restype = None
    sizes = [ctypes.c_int() for _ in range(4)]
    lib.fused_nerf_bwd_f32_sizes(*(ctypes.byref(v) for v in sizes))
    sld, gld, pst, wt = (v.value for v in sizes)
    if (sld, gld, pst, wt) != (_S_V + _VW, _G_IN + 4, WBUF_SIZE + BBUF_SIZE, WPACK_SIZE):
        raise RuntimeError(f"fused_mlp_bwd_f32.cu sizes {(sld, gld, pst, wt)} differ from "
                           f"{(_S_V + _VW, _G_IN + 4, WBUF_SIZE + BBUF_SIZE, WPACK_SIZE)}")
    return lib, sld, gld, pst


@span("mlp.unpack_grads")
def kgrads_to_param_grads(kgrads: Dict[str, torch.Tensor], params, xyz_freqs: int = 10,
                          dir_freqs: int = 4):
    """Kernel-layout gradients -> the standard MLP tree's layout (the inverse
    of ``repack_params``' row permutation and split). ``params`` gives the
    dtypes of the result; biases come back as [out]."""
    d = 3
    dev = kgrads["w1"].device
    inv_x = torch.as_tensor(np.argsort(_emb_perm(d, xyz_freqs)), device=dev)
    inv_d = torch.as_tensor(np.argsort(_emb_perm(d, dir_freqs)), device=dev)

    def like(x, ref):
        return x.to(ref.dtype if isinstance(ref, torch.Tensor) else torch.float32)

    pl_ = params["pts_linears"]
    w0 = torch.cat([kgrads["w0x"], kgrads["w0s"], kgrads["w0c"]])[inv_x]
    w5e = torch.cat([kgrads["w5x"], kgrads["w5s"], kgrads["w5c"]])[inv_x]
    w5 = torch.cat([w5e, kgrads["w5h"]])
    wv = torch.cat([kgrads["wvf"], torch.cat([kgrads["wvx"], kgrads["wvs"], kgrads["wvc"]])[inv_d]])
    ws = {0: w0, 5: w5}
    out = {"pts_linears": []}
    for i, layer in enumerate(pl_):
        w = ws.get(i, kgrads.get(f"w{i}"))
        out["pts_linears"].append({"w": like(w, layer["w"]),
                                   "b": like(kgrads[f"b{i}"][0], layer["b"])})
    for name, wk, bk, w in (("alpha_linear", "wa", "ba", kgrads["wa"]),
                            ("feature_linear", "wf", "bf", kgrads["wf"]),
                            ("rgb_linear", "wr", "br", kgrads["wr"])):
        out[name] = {"w": like(w, params[name]["w"]), "b": like(kgrads[bk][0], params[name]["b"])}
    vl = params["views_linears"][0]
    out["views_linears"] = [{"w": like(wv, vl["w"]), "b": like(kgrads["bv"][0], vl["b"])}]
    return out
