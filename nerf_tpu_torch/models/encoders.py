"""Encoders and the encoder factory; counterpart of ``nerf_tpu/models/encoders.py``.

Frequency encoding, in the channel layout the checkpoints' first-layer rows
follow:
    [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]
out_dim = d * (2*num_freqs + 1): xyz with 10 freqs -> 63, dirs with 4 -> 27.

``get_encoder`` builds every encoder type the JAX package's factory accepts,
with its defaults: ``(fn, dim)`` for one without parameters, ``(params, fn,
dim)`` for a learned one, its parameters drawn from ``generator`` (a CPU
``torch.Generator``, seeded with 0 when none is given, as JAX's factory
takes ``PRNGKey(0)``) and put on ``device``. The trees flatten in JAX's
order (``tree.py``); their random values differ from JAX's, whose trees
``params_from_jax`` carries over. A learned encoder's ``fn(params, x,
plain=False)`` (the D-NeRF types: ``fn(params, pts, t, plain=False)``)
gathers its hash tables through B4 on CUDA tensors, and through the plain
versions everywhere with ``plain=True``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def freq_bands(num_freqs: int) -> np.ndarray:
    """Log-sampled bands 2^0 ... 2^(num_freqs-1)."""
    return 2.0 ** np.linspace(0.0, num_freqs - 1, num_freqs)


def freq_encode(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """x: [..., d] -> [..., d*(2*num_freqs + 1)]."""
    bands = torch.as_tensor(freq_bands(num_freqs), dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * bands[:, None]  # [..., F, d]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)  # [..., F, 2d]
    return torch.cat([x, enc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])], dim=-1)


def freq_out_dim(input_dim: int, num_freqs: int) -> int:
    return input_dim * (2 * num_freqs + 1)


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """The real spherical-harmonics basis of unit directions [..., 3] up to
    ``degree`` (exclusive, 1-4): [..., degree**2]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        out += [-0.4886025119029199 * y, 0.4886025119029199 * z, -0.4886025119029199 * x]
    if degree > 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.31539156525252005 * (2.0 * zz - xx - yy), -1.0925484305920792 * xz,
                0.5462742152960396 * (xx - yy)]
    if degree > 3:
        xx, yy, zz = x * x, y * y, z * z
        out += [-0.5900435899266435 * y * (3 * xx - yy), 2.890611442640554 * x * y * z,
                -0.4570457994644658 * y * (4 * zz - xx - yy),
                0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy),
                -0.4570457994644658 * x * (4 * zz - xx - yy),
                1.445305721320277 * z * (xx - yy), -0.5900435899266435 * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


def sh_out_dim(degree: int = 4) -> int:
    return degree * degree


HASH_TYPES = ("hashgrid", "grid_hash", "cuda_hashgrid")
TRIPLANE_TYPES = ("triplane", "cuda_triplane")
DYNAMIC_HASH_TYPES = ("cuda_hashgrid_4d", "cuda_hashgrid_latent", "cuda_hashgrid_coef",
                      "cuda_motion2d")
DNERF_HASH_TYPES = ("dnerf_ngp_mlp", "dnerf_ngp_tensorf", "cuda_dnerf_ngp_tensorf")
DNERF_TYPES = ("dnerf",) + DNERF_HASH_TYPES + ("dnerf_mlp_tensorf",)


def get_encoder(enc_cfg, generator: torch.Generator = None, device=None):
    """The factory of ``nerf_tpu``'s ``get_encoder``: ``(fn, dim)`` for
    "frequency" and "sphere_harmonics", ``(params, fn, dim)`` for the learned
    types. Raises ``ValueError`` for an unknown type."""
    etype = enc_cfg["type"]
    if etype == "frequency":
        d, f = int(enc_cfg["input_dim"]), int(enc_cfg["freq"])
        return (lambda x: freq_encode(x, f)), freq_out_dim(d, f)
    if etype == "sphere_harmonics":
        deg = int(enc_cfg.get("degree", 4))
        return (lambda x: sh_encode(x, deg)), sh_out_dim(deg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if etype in HASH_TYPES:
        from .hashgrid import hashgrid_encode, hashgrid_out_dim, init_hashgrid

        kw = _hash_kwargs(enc_cfg)
        layout = str(enc_cfg.get("layout", "corner"))
        params = init_hashgrid(generator, n_levels=kw["n_levels"], n_features=kw["n_features"],
                               log2_table_size=kw["log2_table_size"], layout=layout,
                               device=device)

        def fn(p, x, plain=False):
            return hashgrid_encode(p, x, base_resolution=kw["base_resolution"],
                                   per_level_scale=kw["per_level_scale"], layout=layout,
                                   plain=plain)

        return params, fn, hashgrid_out_dim(kw["n_levels"], kw["n_features"])
    if etype in TRIPLANE_TYPES:
        from .triplane import init_triplane, triplane_encode, triplane_out_dim

        F = int(enc_cfg.get("n_features", 16))
        params = init_triplane(generator, resolution=int(enc_cfg.get("resolution", 128)),
                               n_features=F, device=device)
        return params, (lambda p, x, plain=False: triplane_encode(p, x)), triplane_out_dim(F)
    if etype in DYNAMIC_HASH_TYPES:
        return _get_dynamic_hash_encoder(etype, enc_cfg, generator, device)
    if etype in DNERF_TYPES:
        return _get_dnerf_encoder(etype, enc_cfg, generator, device)
    raise ValueError(f"unknown encoder type: {etype}")


def _hash_kwargs(enc_cfg) -> dict:
    return dict(
        n_levels=int(enc_cfg.get("n_levels", 16)),
        n_features=int(enc_cfg.get("n_features", 2)),
        log2_table_size=int(enc_cfg.get("log2_hashmap_size", 19)),
        base_resolution=int(enc_cfg.get("base_resolution", 16)),
        per_level_scale=float(enc_cfg.get("per_level_scale", 1.3819)),
    )


def _get_dynamic_hash_encoder(etype, enc_cfg, generator, device):
    """The dynamic-scene hash variants; ``fn`` takes xyzt [N, 4], the frame
    index in the last channel."""
    from . import hash_variants as hv
    from .hashgrid import hashgrid_out_dim

    kw = _hash_kwargs(enc_cfg)
    init_kw = dict(n_levels=kw["n_levels"], n_features=kw["n_features"],
                   log2_table_size=kw["log2_table_size"], device=device)
    enc_kw = dict(base_resolution=kw["base_resolution"], per_level_scale=kw["per_level_scale"])
    nf = int(enc_cfg.get("num_frames", 60))
    base_dim = hashgrid_out_dim(kw["n_levels"], kw["n_features"])
    if etype == "cuda_hashgrid_4d":
        params = hv.init_hash4d(generator, **init_kw)
        return params, (lambda p, x, plain=False: hv.hash4d_encode(
            p, x, num_frames=nf, plain=plain, **enc_kw)), base_dim
    if etype == "cuda_hashgrid_latent":
        latent_dim = int(enc_cfg.get("latent_dim", 32))
        params = hv.init_hash_latent(generator, num_frames=nf, latent_dim=latent_dim, **init_kw)
        return params, (lambda p, x, plain=False: hv.hash_latent_encode(
            p, x, plain=plain, **enc_kw)), base_dim + latent_dim
    if etype == "cuda_hashgrid_coef":
        params = hv.init_hash_coef(generator, basis_num=int(enc_cfg.get("basis_num", 6)),
                                   coef_hidden=int(enc_cfg.get("coef_hidden", 64)), **init_kw)
        return params, (lambda p, x, plain=False: hv.hash_coef_encode(
            p, x, num_frames=nf, plain=plain, **enc_kw)), base_dim
    params = hv.init_motion2d(generator, mlp_width=int(enc_cfg.get("deform_width", 128)),
                              mlp_depth=int(enc_cfg.get("deform_depth", 7)), **init_kw)
    return params, (lambda p, x, plain=False: hv.motion2d_encode(
        p, x, num_frames=nf, plain=plain, **enc_kw)), 3 * base_dim


def _get_dnerf_encoder(etype, enc_cfg, generator, device):
    """The D-NeRF family: a time-conditioned deformation in front of a
    spatial encoder; ``fn`` takes (pts [N, 3], t) with t in [0, 1]."""
    from .dnerf import deformed_encoder, init_deformation

    xyz_freqs = int(enc_cfg.get("freq", 10))
    time_freqs = int(enc_cfg.get("time_freq", 4))
    deform = init_deformation(generator, xyz_freqs=xyz_freqs, time_freqs=time_freqs,
                              W=int(enc_cfg.get("deform_width", 128)),
                              D=int(enc_cfg.get("deform_depth", 4)), device=device)
    if etype == "dnerf":
        def fn(p, pts, t, plain=False):
            return deformed_encoder(p["deform"], lambda x: freq_encode(x, xyz_freqs),
                                    xyz_freqs, time_freqs)(pts, t)

        return {"deform": deform}, fn, freq_out_dim(3, xyz_freqs)
    if etype in DNERF_HASH_TYPES:
        from .hashgrid import hashgrid_encode, hashgrid_out_dim, init_hashgrid

        kw = _hash_kwargs(enc_cfg)
        grid = init_hashgrid(generator, n_levels=kw["n_levels"], n_features=kw["n_features"],
                             log2_table_size=kw["log2_table_size"], device=device)

        def fn(p, pts, t, plain=False):
            return deformed_encoder(
                p["deform"], lambda x: hashgrid_encode(
                    p["grid"], x, base_resolution=kw["base_resolution"],
                    per_level_scale=kw["per_level_scale"], plain=plain),
                xyz_freqs, time_freqs)(pts, t)

        return ({"deform": deform, "grid": grid}, fn,
                hashgrid_out_dim(kw["n_levels"], kw["n_features"]))
    from .triplane import init_triplane, triplane_encode, triplane_out_dim

    F = int(enc_cfg.get("n_features", 16))
    plane = init_triplane(generator, resolution=int(enc_cfg.get("resolution", 128)),
                          n_features=F, device=device)

    def fn(p, pts, t, plain=False):
        return deformed_encoder(p["deform"], lambda x: triplane_encode(p["planes"], x),
                                xyz_freqs, time_freqs)(pts, t)

    return {"deform": deform, "planes": plane}, fn, triplane_out_dim(F)


# the top-level keys of each learned type's tree (and of the img_fit MLP's)
TREE_KEYS = {
    **{t: {"table"} for t in HASH_TYPES},
    **{t: {"planes"} for t in TRIPLANE_TYPES},
    "cuda_hashgrid_4d": {"grid"},
    "cuda_hashgrid_latent": {"grid", "latent_t"},
    "cuda_hashgrid_coef": {"bases", "coef_grid", "coef_l1", "coef_l2"},
    "cuda_motion2d": {"planes", "mlp", "head"},
    "dnerf": {"deform"},
    **{t: {"deform", "grid"} for t in DNERF_HASH_TYPES},
    "dnerf_mlp_tensorf": {"deform", "planes"},
    "img_fit": {"layers", "head"},
}


def params_from_jax(etype: str, tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's parameter tree of a learned encoder type (or of the
    img_fit MLP, ``etype`` "img_fit"), numpy or JAX arrays, -> the port's
    tree of tensors on ``device``: bfloat16 leaves (the hash tables) stay
    bfloat16 bit for bit, every other leaf is float32. Raises
    ``ValueError`` when the tree's keys are not the type's."""
    if etype not in TREE_KEYS:
        raise ValueError(f"unknown encoder type: {etype}")
    if set(tree) != TREE_KEYS[etype]:
        raise ValueError(f"{etype}: expected the keys {sorted(TREE_KEYS[etype])}, "
                         f"got {sorted(tree)}")

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        arr = np.asarray(node)
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 bits
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
        return torch.from_numpy(np.array(arr, np.float32)).to(device)

    return convert(tree)
