"""Fused frequency encoding + NeRF-MLP forward; counterpart of ``nerf_tpu/ops/fused_mlp.py``.

``fused_nerf_eval`` launches the CUDA kernel ``csrc/fused_mlp.cu`` (the port
of the Pallas ``_fused_kernel``, ``nerf_tpu/ops/fused_mlp.py:129``; wgmma,
its weights streamed from ``wpack``) on CUDA tensors and runs
``fused_nerf_eval_plain``, the same math in plain PyTorch, on CPU tensors.
Both read the weights as ``repack_params`` lays them out:

    layer0:  h = relu(x@W0x + sin(a)@W0s + cos(a)@W0c + b0),  a = x * bands
    layers 1..4: h = relu(h@Wi + bi)
    skip (layer 5): h = relu(x@W5x + sin(a)@W5s + cos(a)@W5c + h@W5h + b5)
    layers 6,7: h = relu(h@Wi + bi)
    sigma = h@Wa + ba ;  feat = h@Wf + bf
    v = relu(feat@Wvf + d@Wvx + sin(b)@Wvs + cos(b)@Wvc + bv),  b = d * bands
    rgb = v@Wr + br ;  out = [rgb, sigma]

Matmul operands are rounded to the weight dtype (bf16 on the serving
path) and summed in float32; the phases ``a`` and ``b`` are formed in
float32, one exact multiply by a power of two per entry.

``fused_nerf_eval_diff`` is the differentiable form (the counterpart of
``nerf_tpu``'s custom-VJP ``fused_nerf_eval_diff``): it takes the standard MLP
tree, repacks it, runs this forward, and its backward is
``ops/fused_mlp_bwd.py`` (the hand-written backward kernel on CUDA tensors).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict

import numpy as np
import torch

from ..models.encoders import freq_bands
from ..tree import tree_flatten, tree_unflatten
from . import build

# packed kernel buffers (csrc/fused_mlp.cu reports the same sizes)
WBUF_SIZE = 594_560  # bf16 weights, in the order of _pack_kernel_buffers
BBUF_SIZE = 2_436  # f32 biases
WPACK_SIZE = 593_920  # bf16, the weight stream of the wgmma kernel (pack_weight_stream)
_EMB_PAD = 16  # the kernel pads the xyz (63) and dir (27) encodings to 16-multiples
# (K, N) of the ten layers' matrices, in wbuf order from offset 0: layer 0 on
# the padded xyz encoding, layers 1-4, the skip layer [enc_x, h], layers 6-7,
# the feature layer, the view layer [feat, enc_d]; the heads follow them
STREAM_LAYERS = ((64, 256), (256, 256), (256, 256), (256, 256), (256, 256), (320, 256),
                 (256, 256), (256, 256), (256, 256), (288, 128))


def _emb_perm(input_dim: int, num_freqs: int) -> np.ndarray:
    """Permutation new->old embedding rows.

    Old (checkpoint) layout: [x(d), sin(f0 x)(d), cos(f0 x)(d), sin(f1 x)...].
    New layout: [x(d), sin-block (f-major, d-minor) (d*F), cos-block (d*F)].
    """
    d, F = input_dim, num_freqs
    idx = list(range(d))
    for f in range(F):
        idx.extend(d + f * 2 * d + j for j in range(d))
    for f in range(F):
        idx.extend(d + f * 2 * d + d + j for j in range(d))
    return np.asarray(idx, np.int64)


def _scale_matrix(input_dim: int, num_freqs: int) -> np.ndarray:
    """S [d, d*F] with S[j, f*d + j] = band[f]: the f-major, d-minor phases."""
    bands = freq_bands(num_freqs)
    S = np.zeros((input_dim, input_dim * num_freqs), np.float32)
    for f in range(num_freqs):
        for j in range(input_dim):
            S[j, f * input_dim + j] = bands[f]
    return S


def _pad_rows(w: torch.Tensor) -> torch.Tensor:
    pad = (-w.shape[0]) % _EMB_PAD
    return torch.cat([w, w.new_zeros(pad, w.shape[1])]) if pad else w


def _pack_kernel_buffers(kp: Dict[str, torch.Tensor]):
    """The kernel's two flat buffers: all weights [K, N] row-major, the
    encoding rows zero-padded to 16-multiples, then all biases."""
    emb0 = _pad_rows(torch.cat([kp["w0x"], kp["w0s"], kp["w0c"]]))
    emb5 = _pad_rows(torch.cat([kp["w5x"], kp["w5s"], kp["w5c"]]))
    embv = _pad_rows(torch.cat([kp["wvx"], kp["wvs"], kp["wvc"]]))
    weights = [emb0, kp["w1"], kp["w2"], kp["w3"], kp["w4"], emb5, kp["w5h"],
               kp["w6"], kp["w7"], kp["wf"], kp["wvf"], embv, kp["wa"], kp["wr"]]
    biases = ["b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7", "bf", "bv", "ba", "br"]
    wbuf = torch.cat([w.reshape(-1) for w in weights])
    bbuf = torch.cat([kp[k].reshape(-1) for k in biases])
    return wbuf, bbuf


def _k_major(m: torch.Tensor) -> torch.Tensor:
    """[K, N] -> flat [K/8, N, 8]: wgmma's K-major canonical layout without
    swizzle (8 K-values of one column are 16 contiguous bytes)."""
    k, n = m.shape
    return m.reshape(k // 8, 8, n).transpose(1, 2).reshape(-1)


def pack_weight_stream(wbuf: torch.Tensor) -> torch.Tensor:
    """The wgmma kernel's weight stream: each layer's [K, N] matrix of
    ``wbuf`` in the K-major layout of ``_k_major``, layer after layer. The
    kernel copies it in chunks of 64 K-rows."""
    parts, off = [], 0
    for k, n in STREAM_LAYERS:
        parts.append(_k_major(wbuf[off: off + k * n].view(k, n)))
        off += k * n
    return torch.cat(parts)


def unpack_weight_stream(wpack: torch.Tensor):
    """The inverse of ``pack_weight_stream``: the ten [K, N] matrices."""
    mats, off = [], 0
    for k, n in STREAM_LAYERS:
        mats.append(wpack[off: off + k * n].reshape(k // 8, n, 8).transpose(1, 2).reshape(k, n))
        off += k * n
    return mats


# The backward chain's weight stream (csrc/fused_mlp_bwd.cu): W^T of each
# layer, in chain order, as (STREAM_LAYERS index, first row, rows) of its
# [K, N] matrix; the encoding parts (enc_d of the view layer, enc_x of the
# skip layer and layer 0) are read only with input gradients.
BWD_STREAM = ((9, 0, 256), (9, 256, 32), (8, 0, 256), (7, 0, 256), (6, 0, 256), (5, 64, 256),
              (5, 0, 64), (4, 0, 256), (3, 0, 256), (2, 0, 256), (1, 0, 256), (0, 0, 64))


def _stream_matrices(wbuf: torch.Tensor):
    mats, off = [], 0
    for k, n in STREAM_LAYERS:
        mats.append(wbuf[off: off + k * n].view(k, n))
        off += k * n
    return mats


def pack_bwd_stream(wbuf: torch.Tensor) -> torch.Tensor:
    """The backward chain's weight stream: for each part of ``BWD_STREAM``,
    rows r0..r0+rows of the layer's [K, N] matrix transposed ([N, rows],
    out = G @ W^T) in the K-major layout of ``_k_major``. Same size as
    ``pack_weight_stream``'s."""
    mats = _stream_matrices(wbuf)
    return torch.cat([_k_major(mats[i][r0: r0 + rows].T.contiguous())
                      for i, r0, rows in BWD_STREAM])


def unpack_bwd_stream(wpack_bwd: torch.Tensor):
    """The inverse of ``pack_bwd_stream``: the ten [K, N] matrices."""
    parts, off = {}, 0
    for i, r0, rows in BWD_STREAM:
        n = STREAM_LAYERS[i][1]
        t = wpack_bwd[off: off + rows * n].reshape(n // 8, rows, 8).transpose(1, 2)
        parts[(i, r0)] = t.reshape(n, rows).T
        off += rows * n
    return [torch.cat([parts[key] for key in sorted(k for k in parts if k[0] == i)])
            for i in range(len(STREAM_LAYERS))]


def repack_params(params: Dict[str, Any], xyz_freqs: int = 10, dir_freqs: int = 4,
                  weight_dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """JAX-layout MLP tree (weights [in, out], e.g. ``NeRFMLP.to_tree()``) ->
    the kernel's weight dict: the entries of ``nerf_tpu``'s ``repack_params``
    plus ``wbuf``/``bbuf``, the flat buffers the CUDA kernels read,
    ``wpack``, the forward kernel's weight stream (``pack_weight_stream``),
    and ``wpack_bwd``, the backward chain's (``pack_bwd_stream``)."""
    d = 3
    perm_x = torch.as_tensor(_emb_perm(d, xyz_freqs))
    perm_d = torch.as_tensor(_emb_perm(d, dir_freqs))
    nx, nd = d * xyz_freqs, d * dir_freqs
    pl_ = params["pts_linears"]

    def f32(x):  # numpy leaves are copied: they may be read-only views
        if isinstance(x, torch.Tensor):
            return x.detach().float()
        return torch.from_numpy(np.array(x, np.float32))

    def wd(x):
        return f32(x).to(weight_dtype)

    def bias(x):
        return f32(x).reshape(1, -1)

    w0 = f32(pl_[0]["w"])
    dev = w0.device
    w0 = w0[perm_x.to(dev)]
    w5 = f32(pl_[5]["w"])
    w5e = w5[: d + 2 * nx][perm_x.to(dev)]
    wv = f32(params["views_linears"][0]["w"])
    wve = wv[256:][perm_d.to(dev)]
    kp = {
        "w0x": wd(w0[:d]), "w0s": wd(w0[d: d + nx]), "w0c": wd(w0[d + nx:]),
        "b0": bias(pl_[0]["b"]),
        "w5x": wd(w5e[:d]), "w5s": wd(w5e[d: d + nx]), "w5c": wd(w5e[d + nx:]),
        "w5h": wd(w5[d + 2 * nx:]), "b5": bias(pl_[5]["b"]),
        "wa": wd(params["alpha_linear"]["w"]), "ba": bias(params["alpha_linear"]["b"]),
        "wf": wd(params["feature_linear"]["w"]), "bf": bias(params["feature_linear"]["b"]),
        "wvx": wd(wve[:d]), "wvs": wd(wve[d: d + nd]), "wvc": wd(wve[d + nd:]),
        "wvf": wd(wv[:256]), "bv": bias(params["views_linears"][0]["b"]),
        "wr": wd(params["rgb_linear"]["w"]), "br": bias(params["rgb_linear"]["b"]),
        "sx": torch.as_tensor(_scale_matrix(d, xyz_freqs), device=dev),
        "sd": torch.as_tensor(_scale_matrix(d, dir_freqs), device=dev),
    }
    for i in (1, 2, 3, 4, 6, 7):
        kp[f"w{i}"] = wd(pl_[i]["w"])
        kp[f"b{i}"] = bias(pl_[i]["b"])
    kp["wbuf"], kp["bbuf"] = _pack_kernel_buffers(kp)
    kp["wpack"] = pack_weight_stream(kp["wbuf"])
    kp["wpack_bwd"] = pack_bwd_stream(kp["wbuf"])
    return kp


def _phases(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x @ S as exact float32 products (S has one power of two per column),
    never through a matmul that TF32 or bf16 could round."""
    return x.repeat(1, s.shape[1] // s.shape[0]) * s.sum(0)


def fused_nerf_eval_plain(kp: Dict[str, torch.Tensor], pts: torch.Tensor,
                          dirs: torch.Tensor, accumulate: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The kernel's math in plain PyTorch. pts, dirs: [P, 3] -> raw [P, 4] f32.
    Each product rounds its activations to the weights' dtype and sums in
    ``accumulate`` (float64 gives a second summation order, which shows how
    far bf16 rounding alone moves the outputs)."""
    def dot(a, w):
        return a.to(w.dtype).to(accumulate) @ w.to(accumulate)

    def relu(v):
        return torch.clamp_min(v, 0.0)

    x = pts.float()
    a = _phases(x, kp["sx"])
    sa, ca = torch.sin(a), torch.cos(a)
    h = relu(dot(x, kp["w0x"]) + dot(sa, kp["w0s"]) + dot(ca, kp["w0c"]) + kp["b0"])
    for i in (1, 2, 3, 4):
        h = relu(dot(h, kp[f"w{i}"]) + kp[f"b{i}"])
    h = relu(dot(x, kp["w5x"]) + dot(sa, kp["w5s"]) + dot(ca, kp["w5c"])
             + dot(h, kp["w5h"]) + kp["b5"])
    for i in (6, 7):
        h = relu(dot(h, kp[f"w{i}"]) + kp[f"b{i}"])
    sigma = dot(h, kp["wa"]) + kp["ba"]
    feat = dot(h, kp["wf"]) + kp["bf"]
    dd = dirs.float()
    b = _phases(dd, kp["sd"])
    v = relu(dot(feat, kp["wvf"]) + dot(dd, kp["wvx"]) + dot(torch.sin(b), kp["wvs"])
             + dot(torch.cos(b), kp["wvc"]) + kp["bv"])
    rgb = dot(v, kp["wr"]) + kp["br"]
    return torch.cat([rgb, sigma], dim=-1).float()


def _check_launch(kp, pts, dirs) -> int:
    P = pts.shape[0]
    if P > build.MAX_LAUNCH_ROWS:
        raise ValueError(f"{P} points in one call; split it into calls of at most "
                         f"{build.MAX_LAUNCH_ROWS}")
    build.check_cuda("pts", pts, torch.float32, (P, 3))
    build.check_cuda("dirs", dirs, torch.float32, (P, 3))
    build.check_cuda("wbuf", kp["wbuf"], torch.bfloat16, (WBUF_SIZE,), align=32)
    build.check_cuda("bbuf", kp["bbuf"], torch.float32, (BBUF_SIZE,))
    return P


def fused_nerf_eval(kp: Dict[str, torch.Tensor], pts: torch.Tensor,
                    dirs: torch.Tensor) -> torch.Tensor:
    """pts, dirs: [P, 3] float32 -> raw [P, 4] (rgb_raw, sigma_raw) float32.

    CUDA tensors go through the CUDA kernel, CPU tensors through
    ``fused_nerf_eval_plain``. Forward only: tensors that require grad raise
    (``fused_nerf_eval_diff`` differentiates).
    """
    if pts.requires_grad or dirs.requires_grad:
        raise RuntimeError("fused_nerf_eval is forward-only; use fused_nerf_eval_diff "
                           "for gradients")
    if pts.device.type == "cpu":
        return fused_nerf_eval_plain(kp, pts, dirs)
    P = _check_launch(kp, pts, dirs)
    build.check_cuda("wpack", kp["wpack"], torch.bfloat16, (WPACK_SIZE,), align=16)
    out = torch.empty((P, 4), dtype=torch.float32, device=pts.device)
    rc = _lib().launch_fused_nerf(pts.data_ptr(), dirs.data_ptr(), kp["wpack"].data_ptr(),
                                  kp["wbuf"].data_ptr(), kp["bbuf"].data_ptr(),
                                  out.data_ptr(), P,
                                  torch.cuda.current_stream(pts.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_nerf kernel launch failed: CUDA error {rc}")
    fused_nerf_eval.launches += 1
    return out


fused_nerf_eval.launches = 0


def fused_nerf_eval_wmma(kp: Dict[str, torch.Tensor], pts: torch.Tensor,
                         dirs: torch.Tensor) -> torch.Tensor:
    """The previous forward kernel (nvcuda::wmma, ``csrc/fused_mlp.cuh``; the
    wmma backward, ``fused_nerf_bwd_wmma``, recomputes its forward with it),
    CUDA tensors only. No
    path of the port calls it: it is the yardstick that the GPU tests and
    ``chip_smoke.py`` hold ``fused_nerf_eval`` against."""
    P = _check_launch(kp, pts, dirs)
    out = torch.empty((P, 4), dtype=torch.float32, device=pts.device)
    rc = _lib().launch_fused_nerf_wmma(pts.data_ptr(), dirs.data_ptr(), kp["wbuf"].data_ptr(),
                                       kp["bbuf"].data_ptr(), out.data_ptr(), P,
                                       torch.cuda.current_stream(pts.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_nerf wmma kernel launch failed: CUDA error {rc}")
    return out


def wgmma_layer_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [128, 256] @ w [256, 256] (bf16 CUDA tensors) -> float32, through the
    forward kernel's own ring, descriptors and wgmma products: the check of
    those parts alone, for the GPU tests and ``chip_smoke.py``."""
    build.check_cuda("a", a, torch.bfloat16, (128, 256), align=16)
    build.check_cuda("w", w, torch.bfloat16, (256, 256))
    wp = _k_major(w)
    out = torch.empty((128, 256), dtype=torch.float32, device=a.device)
    rc = _lib().launch_wgmma_layer_test(a.data_ptr(), wp.data_ptr(), out.data_ptr(),
                                        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wgmma layer test launch failed: CUDA error {rc}")
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fused_mlp")
    p = ctypes.c_void_p
    lib.launch_fused_nerf.argtypes = [p, p, p, p, p, p, ctypes.c_int, p]
    lib.launch_fused_nerf_wmma.argtypes = [p, p, p, p, p, ctypes.c_int, p]
    lib.launch_wgmma_layer_test.argtypes = [p, p, p, p]
    for fn in (lib.launch_fused_nerf, lib.launch_fused_nerf_wmma, lib.launch_wgmma_layer_test):
        fn.restype = ctypes.c_int
    lib.fused_nerf_buffer_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.fused_nerf_buffer_sizes.restype = None
    sizes = [ctypes.c_int() for _ in range(3)]
    lib.fused_nerf_buffer_sizes(*(ctypes.byref(v) for v in sizes))
    want = (WBUF_SIZE, BBUF_SIZE, WPACK_SIZE)
    if tuple(v.value for v in sizes) != want:
        raise RuntimeError(f"fused_mlp.cu buffer sizes {tuple(v.value for v in sizes)} "
                           f"differ from {want}")
    return lib


def supports(opts) -> bool:
    """The fused kernel covers the lego architecture: 8x256, skip after
    layer 4, the view-direction head, 10/4 frequency bands."""
    return (opts.mlp_depth == 8 and opts.mlp_width == 256
            and tuple(opts.skips) == (4,) and opts.use_viewdirs
            and opts.xyz_freqs == 10 and opts.dir_freqs == 4)


class _FusedNeRF(torch.autograd.Function):
    """raw = MLP(pts, dirs) with the MLP's standard-layout leaves as inputs.
    Forward: ``fused_nerf_eval`` (or its plain version); backward:
    ``fused_nerf_bwd`` (or its plain version), then ``kgrads_to_param_grads``."""

    @staticmethod
    def forward(ctx, pts, dirs, spec, freqs, weight_dtype, plain, *leaves):
        tree = tree_unflatten(spec, [leaf.detach() for leaf in leaves])
        kp = repack_params(tree, *freqs, weight_dtype=weight_dtype)
        fn = fused_nerf_eval_plain if plain else fused_nerf_eval
        raw = fn(kp, pts.detach(), dirs.detach())
        ctx.save_for_backward(pts, dirs)
        ctx.kp, ctx.tree, ctx.freqs, ctx.plain = kp, tree, freqs, plain
        return raw

    @staticmethod
    def backward(ctx, g):
        from .fused_mlp_bwd import fused_nerf_bwd, fused_nerf_bwd_plain, kgrads_to_param_grads

        pts, dirs = ctx.saved_tensors
        want_inputs = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        fn = fused_nerf_bwd_plain if ctx.plain else fused_nerf_bwd
        kgrads, dpts, ddirs = fn(ctx.kp, pts.detach(), dirs.detach(),
                                 g.float().contiguous(), input_grads=want_inputs)
        grads, _ = tree_flatten(kgrads_to_param_grads(kgrads, ctx.tree, *ctx.freqs))
        return (dpts if ctx.needs_input_grad[0] else None,
                ddirs if ctx.needs_input_grad[1] else None, None, None, None, None, *grads)


def fused_nerf_eval_diff(params: Dict[str, Any], pts: torch.Tensor, dirs: torch.Tensor,
                         xyz_freqs: int = 10, dir_freqs: int = 4,
                         weight_dtype: torch.dtype = torch.bfloat16,
                         plain: bool = False) -> torch.Tensor:
    """Differentiable ``fused_nerf_eval``. ``params``: the standard MLP tree of
    tensors (weights [in, out], e.g. a train state's ``params["coarse"]``);
    its leaves, pts and dirs get gradients. CUDA tensors take the forward and
    the backward kernel, CPU tensors (or ``plain=True``) their plain versions."""
    leaves, spec = tree_flatten(params)
    return _FusedNeRF.apply(pts, dirs, spec, (xyz_freqs, dir_freqs), weight_dtype, plain,
                            *leaves)


def query_network(params: Dict[str, Any], pts: torch.Tensor, viewdirs: torch.Tensor,
                  plain: bool = False, xyz_freqs: int = 10, dir_freqs: int = 4,
                  weight_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4] through the fused
    kernel (``plain=True``: through its plain version on any device).
    ``params`` is either kernel weights (``repack_params``; forward only, the
    serving path) or the standard MLP tree (differentiable, the train path;
    the frequencies and the weight dtype say how to repack it)."""
    n, s, _ = pts.shape
    dirs = viewdirs[:, None, :].expand(n, s, 3).reshape(-1, 3).float()
    flat = pts.reshape(-1, 3).float().contiguous()
    if "wbuf" in params:
        fn = fused_nerf_eval_plain if plain else fused_nerf_eval
        return fn(params, flat, dirs).reshape(n, s, 4)
    return fused_nerf_eval_diff(params, flat, dirs, xyz_freqs, dir_freqs, weight_dtype,
                                plain).reshape(n, s, 4)
