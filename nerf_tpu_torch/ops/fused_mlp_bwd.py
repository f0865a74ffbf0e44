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
WMMA_TILE, WMMA_MAX_SPLITS, WMMA_POINTS_PER_SPLIT = 64, 64, 1024  # the wmma backward's


def splits_for(n_points: int):
    """(weight-gradient ranges, head ranges) for n_points: at most
    WGRAD_SPLITS and HEAD_SPLITS, and no more than the 64-point blocks
    there are."""
    blocks = n_points // SLAB_ROWS
    return max(1, min(WGRAD_SPLITS, blocks)), max(1, min(HEAD_SPLITS, blocks))


def wmma_splits_for(n_points: int) -> int:
    """Point ranges of the wmma backward's reduction: one per 1024 points,
    at most 64."""
    return max(1, min(WMMA_MAX_SPLITS, n_points // WMMA_POINTS_PER_SPLIT))


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
                         input_grads: bool = True
                         ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor],
                                    Optional[torch.Tensor]]:
    """The kernels' math in plain PyTorch. pts, dirs [P, 3], g [P, 4] (the
    gradient of raw [P, 4]) -> ({key: f32 grad}, dpts, ddirs [P, 3] or None).
    ``accumulate`` float64 sums every product in another order, which shows
    how far bf16 rounding alone moves the gradients."""
    return backward_from_activations(kp, plain_activations(kp, pts, dirs, accumulate), g,
                                     accumulate, input_grads)


def backward_from_activations(kp: Dict[str, torch.Tensor], acts: Dict[str, torch.Tensor],
                              g: torch.Tensor, accumulate: torch.dtype = torch.float32,
                              input_grads: bool = True):
    """The backward half of ``fused_nerf_bwd_plain``, given the forward's
    activations (``plain_activations`` or ``stash_activations``)."""
    wdt = kp["w1"].dtype

    def rnd(a):  # an operand as the tensor cores see it
        return a.to(wdt).to(accumulate)

    def dx(gr, w):  # gr [P, N] @ w[K, N]^T -> [P, K]
        return gr @ w.to(accumulate).T

    def dw(x, gr):  # x[P, K]^T @ gr[P, N] -> [K, N]
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
    Scratch of ~10 KB a point (the activation stash and the layer
    gradients) lives until the call returns."""
    if pts.device.type == "cpu":
        return fused_nerf_bwd_plain(kp, pts, dirs, g, input_grads=input_grads)
    out = launch_full(kp, pts, dirs, g, input_grads, unpack=False)
    fused_nerf_bwd.launches += 1
    return out["kgrads"], out["dpts"], out["ddirs"]


def _check_inputs(kp, pts, dirs, g) -> int:
    P = pts.shape[0]
    if P > build.MAX_LAUNCH_ROWS:
        raise ValueError(f"{P} points in one call; split it into calls of at most "
                         f"{build.MAX_LAUNCH_ROWS}")
    build.check_cuda("pts", pts, torch.float32, (P, 3))
    build.check_cuda("dirs", dirs, torch.float32, (P, 3))
    build.check_cuda("g", g, torch.float32, (P, 4), align=16)
    build.check_cuda("wbuf", kp["wbuf"], torch.bfloat16, (WBUF_SIZE,), align=32)
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


def fused_nerf_bwd_wmma(kp: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
                        g: torch.Tensor, input_grads: bool = True):
    """The wmma backward (``csrc/fused_mlp_bwd_wmma.cuh``: the wmma forward
    with a row stash, wmma products), CUDA tensors only. No path of the port
    calls it: it is the yardstick that the GPU tests and ``chip_smoke.py``
    hold ``fused_nerf_bwd`` against. Returns {kgrads, dpts, ddirs, args,
    keep}: ``_lib()[0].launch_fused_nerf_bwd_wmma(*args)`` launches it again
    while ``keep`` (the tensors it reads and writes) lives."""
    P = _check_inputs(kp, pts, dirs, g)
    lib, sld, gld, pst, _, _ = _lib()
    pts, dirs, g = _pad(WMMA_TILE, pts, dirs, g)
    n = pts.shape[0]
    splits = wmma_splits_for(n)
    dev = pts.device
    scratch = [torch.empty((n, sld), dtype=torch.bfloat16, device=dev),
               torch.empty((n, gld), dtype=torch.bfloat16, device=dev),
               torch.empty((splits, pst), dtype=torch.float32, device=dev)]
    flat = torch.empty(WBUF_SIZE + BBUF_SIZE, dtype=torch.float32, device=dev)
    dpts = torch.empty((n, 3), dtype=torch.float32, device=dev) if input_grads else None
    ddirs = torch.empty((n, 3), dtype=torch.float32, device=dev) if input_grads else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = [pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), kp["wbuf"].data_ptr(),
            kp["bbuf"].data_ptr(), *(t.data_ptr() for t in scratch), flat.data_ptr(), ptr(dpts),
            ptr(ddirs), n, splits, int(input_grads), torch.cuda.current_stream(dev).cuda_stream]
    rc = lib.launch_fused_nerf_bwd_wmma(*args)
    if rc != 0:
        raise RuntimeError(f"fused_nerf_bwd_wmma kernel launch failed: CUDA error {rc}")
    return {"kgrads": _grads_of(flat, kp), "dpts": dpts[:P] if input_grads else None,
            "ddirs": ddirs[:P] if input_grads else None, "args": args,
            "keep": (pts, dirs, g, scratch, flat, dpts, ddirs)}


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
    lib.launch_fused_nerf_bwd_wmma.argtypes = [p] * 11 + [i] * 3 + [p]
    lib.launch_wgrad_test.argtypes = [p] * 4
    for fn in (lib.launch_fused_nerf_bwd, lib.launch_fused_nerf_bwd_wmma, lib.launch_wgrad_test):
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
