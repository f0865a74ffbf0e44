"""The hierarchical volume renderer; counterpart of ``nerf_tpu/render/renderer.py``.

``render_rays``: coarse samples (refocused by the ESS grid) -> query ->
composite -> inverse-CDF fine samples on the coarse weights -> merge-sort ->
fine query -> composite. ``render_image`` renders an image in tiles of
``tile_rays`` rays, one Python loop iteration each.

The query goes through the fused MLP kernel and compositing through the
integrate kernel; on CPU tensors both wrappers run their plain versions.
``use_fused_mlp=False`` / ``use_integrate_kernel=False`` take the plain
versions on any device. A hash-grid model (``xyz_encoder_type ==
"hashgrid"``) queries through ``query_hashgrid`` instead: the hash encoder's
row gather (the B4 kernel; with ``use_fused_mlp=False``, the switch of the
query's kernels as ``nerf_tpu``'s ``use_pallas`` is, its plain version), the
directions' frequency encoding and the MLP in plain PyTorch, as the JAX
package runs that MLP through XLA.

Serving renders under ``no_grad`` with kernel weights (``kernel_params``).
Training (``render_rays(..., train=True)``) takes the standard MLP trees,
draws random fine-sample positions, detaches the fine-sampling inputs
(``detach_fine_sampling``) and differentiates through both kernels' autograd
Functions (the backward kernel of the MLP; a recomputed compositing).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from ..models.encoders import freq_encode, freq_out_dim
from ..models.hashgrid import hashgrid_encode, table_shape
from ..models.nerf_mlp import apply_nerf_mlp
from ..ops.fused_mlp import (fused_nerf_eval, fused_nerf_eval_plain, query_network,
                             repack_params, supports)
from ..ops.integrate import composite_kernel
from ..tree import tree_map
from . import occupancy as occ
from .composite import composite, density_activation
from .rays import image_rays
from .sampling import sample_coarse, sample_pdf

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    n_samples: int = 64
    n_importance: int = 128
    near: float = 2.0
    far: float = 6.0
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    white_bkgd: bool = True
    use_viewdirs: bool = True
    lindisp: bool = False
    enable_ert: bool = True
    ert_threshold: float = 0.01
    enable_ess: bool = True
    xyz_freqs: int = 10
    dir_freqs: int = 4
    # the xyz encoder: "frequency" or "hashgrid" (models/hashgrid.py)
    xyz_encoder_type: str = "frequency"
    hash_levels: int = 16
    hash_features: int = 2
    hash_log2_size: int = 19
    hash_base_res: int = 16
    hash_scale: float = 1.3819
    hash_dtype: str = "bfloat16"
    hash_layout: str = "corner"
    sigma_activation: str = "relu"
    mlp_depth: int = 8
    mlp_width: int = 256
    skips: Tuple[int, ...] = (4,)
    compute_dtype: str = "bfloat16"
    tile_rays: int = 8192
    use_fused_mlp: bool = True
    use_integrate_kernel: bool = True
    # detach the coarse weights and bin mid-points from the fine sampling
    # (original NeRF; nerf_tpu's default, renderer.py:104-108)
    detach_fine_sampling: bool = True

    @property
    def hashgrid(self) -> bool:
        return self.xyz_encoder_type == "hashgrid"

    @property
    def input_ch(self) -> int:
        if self.hashgrid:
            return self.hash_levels * self.hash_features
        return freq_out_dim(3, self.xyz_freqs)

    def model_shape(self) -> Dict[str, Any]:
        """The shapes ``train.checkpoint.load_params`` reads a model by."""
        return dict(D=self.mlp_depth, W=self.mlp_width, input_ch=self.input_ch,
                    input_ch_views=self.input_ch_views, skips=self.skips,
                    hash_table=table_shape(self.hash_levels, self.hash_features,
                                           self.hash_log2_size, self.hash_layout)
                    if self.hashgrid else None)

    @property
    def input_ch_views(self) -> int:
        return freq_out_dim(3, self.dir_freqs)

    @classmethod
    def from_cfg(cls, cfg) -> "RenderOptions":
        """The options of a ``nerf_tpu`` config, for the models the port
        runs: the NeRF with the frequency or the hash-grid xyz encoder,
        without compaction."""
        net = cfg.network
        if str(cfg.get("network_module", "nerf")) != "nerf":
            raise NotImplementedError(f"network_module {cfg.network_module!r} is not ported")
        xyz = net.xyz_encoder
        kind = xyz.get("type", "frequency")
        if kind not in ("frequency", "hashgrid", "grid_hash"):
            raise NotImplementedError(f"xyz encoder {kind!r} is not ported")
        if float(cfg.get("ess_compaction", 0.0) or 0.0) != 0.0:
            raise NotImplementedError("ess_compaction is not ported")
        hash_kw = {}
        if kind != "frequency":
            hash_kw = dict(
                xyz_encoder_type="hashgrid",
                hash_levels=int(xyz.get("n_levels", 16)),
                hash_features=int(xyz.get("n_features", 2)),
                hash_log2_size=int(xyz.get("log2_hashmap_size", 19)),
                hash_base_res=int(xyz.get("base_resolution", 16)),
                hash_scale=float(xyz.get("per_level_scale", 1.3819)),
                hash_dtype=str(xyz.get("dtype", "bfloat16")),
                hash_layout=str(xyz.get("layout", "corner")))
        ta = cfg.task_arg
        return cls(
            **hash_kw,
            n_samples=int(ta.N_samples),
            n_importance=int(ta.N_importance),
            near=float(cfg.get("near", 2.0)),
            far=float(cfg.get("far", 6.0)),
            perturb=float(ta.perturb),
            raw_noise_std=float(ta.raw_noise_std),
            white_bkgd=bool(ta.white_bkgd),
            use_viewdirs=bool(ta.use_viewdirs),
            lindisp=bool(ta.lindisp),
            enable_ert=bool(cfg.get("enable_ert", True)),
            ert_threshold=float(cfg.get("ert_threshold", 0.01)),
            enable_ess=bool(cfg.get("enable_ess", True)),
            xyz_freqs=int(net.xyz_encoder.get("freq", 10)),
            dir_freqs=int(net.dir_encoder.freq),
            sigma_activation=str(net.get("sigma_activation", "relu")),
            mlp_depth=int(net.nerf.D),
            mlp_width=int(net.nerf.W),
            skips=tuple(net.nerf.skips),
            compute_dtype=str(net.get("dtype", "bfloat16")),
            tile_rays=int(cfg.get("render_tile_rays", 8192)),
            use_fused_mlp=bool(cfg.get("use_pallas_kernels", True)),
            use_integrate_kernel=bool(cfg.get("use_pallas_integrate", True)),
        )


def kernel_params(tree: Mapping[str, Any], opts: RenderOptions,
                  device: Union[str, torch.device] = "cpu") -> Dict[str, Dict]:
    """{"coarse": mlp_tree, "fine": mlp_tree} in the JAX layout (``load_params``;
    weights [in, out]) -> their ``repack_params`` weights in
    ``opts.compute_dtype``, on ``device``.

    The CUDA kernel takes bfloat16 weights only: float32 weights on a CUDA
    device raise unless ``opts.use_fused_mlp`` is off (the plain version).
    A hash-grid model keeps its tree: float32 MLP leaves and the table in
    ``opts.hash_dtype``, as tensors on ``device``."""
    if opts.hashgrid:
        dev = torch.device(device)

        def leaf(x, dtype=torch.float32):
            return torch.as_tensor(x).detach().to(device=dev, dtype=dtype)

        return {name: {**tree_map(leaf, {k: v for k, v in sub.items() if k != "xyz_encoder"}),
                       "xyz_encoder": {"table": leaf(sub["xyz_encoder"]["table"],
                                                     _DTYPES[opts.hash_dtype])}}
                for name, sub in tree.items()}
    if not supports(opts):
        raise NotImplementedError("only the 8x256 skip-4 view-direction NeRF "
                                  "with 10/4 frequency bands is ported")
    dev = torch.device(device)
    check_weight_dtype(opts, dev)
    return {name: {k: v.to(dev) for k, v in repack_params(
                sub, opts.xyz_freqs, opts.dir_freqs, _DTYPES[opts.compute_dtype]).items()}
            for name, sub in tree.items()}


def check_weight_dtype(opts: RenderOptions, device: torch.device) -> None:
    """The CUDA kernels take bfloat16 weights only: raise for float32 weights
    on a CUDA device unless ``opts.use_fused_mlp`` is off (the plain version)."""
    if (device.type == "cuda" and opts.use_fused_mlp and not opts.hashgrid
            and opts.compute_dtype != "bfloat16"):
        raise NotImplementedError(
            f"the fused CUDA kernel takes bfloat16 weights, not {opts.compute_dtype}; "
            "set use_pallas_kernels False to run them through the plain version")


# points per hash-grid density evaluation: each point gathers L rows and
# keeps L x 8 float32 weights and products, ~0.2 KB a level at 16 levels
HASH_DENSITY_CHUNK = 1 << 18


def make_density_fn(kp: Dict[str, torch.Tensor], opts: RenderOptions
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """[M, 3] -> activated sigma of the MLP ``kp``, for grid rebuilds. Sigma
    does not depend on the view direction, so the directions are zeros (for
    the hash-grid model a zero direction embedding, as the JAX package's
    trainer feeds it, evaluated in chunks of ``HASH_DENSITY_CHUNK`` points)."""
    if opts.hashgrid:
        def hash_density(pts: torch.Tensor) -> torch.Tensor:
            out = []
            for p in pts.split(HASH_DENSITY_CHUNK):
                emb = _hash_embed(kp, p, opts)
                x = torch.cat([emb, emb.new_zeros(p.shape[0], opts.input_ch_views)], dim=-1)
                raw = apply_nerf_mlp(kp, x, opts.input_ch, opts.skips,
                                     _DTYPES[opts.compute_dtype])
                out.append(density_activation(raw[:, 3], opts.sigma_activation))
            return torch.cat(out)

        return hash_density

    fn = fused_nerf_eval if opts.use_fused_mlp else fused_nerf_eval_plain

    def density(pts: torch.Tensor) -> torch.Tensor:
        raw = fn(kp, pts.contiguous(), torch.zeros_like(pts))
        return density_activation(raw[:, 3], opts.sigma_activation)

    return density


def _hash_embed(params, pts: torch.Tensor, opts: RenderOptions) -> torch.Tensor:
    return hashgrid_encode(params["xyz_encoder"], pts, base_resolution=opts.hash_base_res,
                           per_level_scale=opts.hash_scale, layout=opts.hash_layout,
                           plain=not opts.use_fused_mlp)


def query_hashgrid(params: Mapping[str, Any], pts: torch.Tensor, viewdirs: torch.Tensor,
                   opts: RenderOptions) -> torch.Tensor:
    """pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4] of a hash-grid model
    (the tree of ``init_nerf_params``/``kernel_params``, with "xyz_encoder"):
    hash encoding, the directions' frequency encoding, the MLP."""
    n, s, _ = pts.shape
    emb = _hash_embed(params, pts.reshape(-1, 3), opts)
    if opts.use_viewdirs:
        dirs = viewdirs[:, None, :].expand(n, s, 3).reshape(-1, 3)
        emb = torch.cat([emb, freq_encode(dirs, opts.dir_freqs)], dim=-1)
    raw = apply_nerf_mlp(params, emb, opts.input_ch, opts.skips, _DTYPES[opts.compute_dtype])
    return raw.reshape(n, s, 4)


def _composite(raw, z_vals, rays_d, opts: RenderOptions, generator):
    if opts.raw_noise_std > 0.0:
        return composite(raw, z_vals, rays_d, raw_noise_std=opts.raw_noise_std,
                         generator=generator, white_bkgd=opts.white_bkgd,
                         ert_threshold=opts.ert_threshold if opts.enable_ert else None,
                         sigma_activation=opts.sigma_activation)
    return composite_kernel(raw, z_vals, rays_d, white_bkgd=opts.white_bkgd,
                            ert_threshold=opts.ert_threshold if opts.enable_ert else 0.0,
                            sigma_activation=opts.sigma_activation,
                            plain=not opts.use_integrate_kernel)


def render_rays(params: Mapping[str, Dict[str, torch.Tensor]], rays_o: torch.Tensor,
                rays_d: torch.Tensor, opts: RenderOptions,
                grid: Optional[occ.OccupancyGrid] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> Dict[str, torch.Tensor]:
    """Hierarchical render of a [N, 3] ray batch. ``params``: {"coarse",
    "fine"}, kernel weights (``kernel_params``) or, to differentiate, the
    standard MLP trees. Returns rgb_map_0 / disp_map_0 / acc_map_0 /
    depth_map_0 (coarse), rgb_map / ... (fine), the coarse and fine weights
    and z values. ``train``: random fine-sample positions, gradients on;
    otherwise ``no_grad`` and deterministic fine samples."""
    with contextlib.nullcontext() if train else torch.no_grad():
        return _render_rays(params, rays_o, rays_d, opts, grid, generator, train)


def _render_rays(params, rays_o, rays_d, opts: RenderOptions, grid, generator, train):
    def query(model, pts):
        if opts.hashgrid:
            return query_hashgrid(model, pts, rays_d, opts)
        return query_network(model, pts, rays_d, plain=not opts.use_fused_mlp,
                             xyz_freqs=opts.xyz_freqs, dir_freqs=opts.dir_freqs,
                             weight_dtype=_DTYPES[opts.compute_dtype])

    if opts.enable_ess and grid is not None:
        z_vals = occ.sample_coarse_with_ess(
            grid, rays_o, rays_d, opts.n_samples, opts.near, opts.far,
            perturb=opts.perturb, lindisp=opts.lindisp, generator=generator)
    else:
        z_vals = sample_coarse(rays_o.shape[0], opts.n_samples, opts.near, opts.far,
                               perturb=opts.perturb, lindisp=opts.lindisp,
                               generator=generator, device=rays_o.device)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., None]
    raw = query(params["coarse"], pts)
    out_c = _composite(raw, z_vals.contiguous(), rays_d, opts, generator)
    ret = {"rgb_map_0": out_c["rgb_map"], "disp_map_0": out_c["disp_map"],
           "acc_map_0": out_c["acc_map"], "depth_map_0": out_c["depth_map"],
           "coarse_weights": out_c["weights"], "coarse_z_vals": z_vals}
    if opts.n_importance > 0:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        w_fine = out_c["weights"][..., 1:-1]
        if opts.detach_fine_sampling:
            z_mid, w_fine = z_mid.detach(), w_fine.detach()
        z_fine = sample_pdf(z_mid, w_fine, opts.n_importance, deterministic=not train,
                            generator=generator)
        z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
        pts_f = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., None]
        raw_f = query(params["fine"], pts_f)
        out_f = _composite(raw_f, z_all.contiguous(), rays_d, opts, generator)
        ret.update(rgb_map=out_f["rgb_map"], disp_map=out_f["disp_map"],
                   acc_map=out_f["acc_map"], depth_map=out_f["depth_map"],
                   fine_weights=out_f["weights"], fine_z_vals=z_all)
    return ret


@torch.no_grad()
def render_image(params: Mapping[str, Dict[str, torch.Tensor]], pose: torch.Tensor,
                 K: torch.Tensor, H: int, W: int, opts: RenderOptions,
                 grid: Optional[occ.OccupancyGrid] = None,
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Render an HxW image in tiles of ``opts.tile_rays`` rays. Returns the
    maps reshaped to [H, W, 3] (rgb) and [H, W] (the others)."""
    rays_o, rays_d = image_rays(H, W, K, pose)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    parts: Dict[str, list] = {}
    for t0 in range(0, H * W, opts.tile_rays):
        sl = slice(t0, t0 + opts.tile_rays)
        out = render_rays(params, rays_o[sl], rays_d[sl], opts, grid=grid, generator=generator)
        for k, v in out.items():
            if k.endswith("map") or k.endswith("map_0"):
                parts.setdefault(k, []).append(v)
    ret = {}
    for k, vs in parts.items():
        flat = torch.cat(vs)
        ret[k] = flat.reshape(H, W, 3) if k.startswith("rgb_map") else flat.reshape(H, W)
    return ret
