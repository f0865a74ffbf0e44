"""The hierarchical volume renderer; counterpart of ``nerf_tpu/render/renderer.py``.

``render_rays``: coarse samples (refocused by the ESS grid) -> query ->
composite -> inverse-CDF fine samples on the coarse weights -> merge-sort ->
fine query -> composite. ``render_image`` renders an image in tiles of
``tile_rays`` rays, one Python loop iteration each.

The query goes through the fused MLP kernel (bf16 or float32 weights) and
compositing through the integrate kernel; on CPU tensors both wrappers run
their plain versions. ``use_fused_mlp=False`` / ``use_integrate_kernel=False``
take the plain versions on any device. A hash-grid model (``xyz_encoder_type
== "hashgrid"``) queries through ``query_mlp`` instead: the hash
encoder's row gather (the B4 kernel; with ``use_fused_mlp=False``, the switch
of the query's kernels as ``nerf_tpu``'s ``use_pallas`` is, its plain
version), the directions' frequency encoding and the MLP in plain PyTorch, as
the JAX package runs that MLP through XLA. So does a frequency NeRF of any
other shape than the fused kernel's (``supports``; ``query_mlp``): its
encodings and MLP in plain PyTorch, as JAX's ``query_network_xla``. A
KiloNeRF model (``network_type == "kilonerf"``) queries its voxel-routed
networks (``ops/kilonerf.py``) for both passes, and its grid-rebuild density
drops no point. Instant-NGP's network (``network_type == "ngp"``,
``models/ngp.py``) is one network for the one pass it renders
(``N_importance`` 0: ``params`` is ``{"coarse": net}``), queried by
``query_ngp``: the hash encoder's gather (B4) over its own box, the
spherical harmonics of the direction, its two MLPs in plain PyTorch.

Compaction (``RenderOptions.ess_compaction`` > 0, evaluation only): the
fine pass evaluates only the samples that lie in occupied voxels
(``fine_pass_mask``), gathered into a batch of
``compaction_capacity`` points (a multiple of 256) that reaches the MLP as
[cap, 1, 3] points with their own view directions; samples left out get
``EMPTY_SIGMA_RAW``. ``calibrate_compaction`` sets the fraction from a
probe batch's kept rate (``ess_compaction: auto``).

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
from ..models import ngp as ngp_model
from ..models.hashgrid import hashgrid_encode, table_shape
from ..models.nerf_mlp import apply_nerf_mlp
from ..ops.fused_mlp import (KERNEL_DTYPES, fused_nerf_eval, fused_nerf_eval_plain,
                             query_network, repack_params, supports)
from ..ops.integrate import composite_kernel
from ..ops.kilonerf import KiloConfig, kilonerf_eval, no_drop_capacity, query_network_kilonerf
from ..tree import tree_map
from ..utils.profiling import span
from . import occupancy as occ
from .composite import EMPTY_SIGMA_RAW, composite, density_activation
from .rays import image_rays
from .sampling import sample_coarse, sample_pdf

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


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
    # the fine pass's compaction capacity as a fraction of its points; 0 is
    # off, -1 is "auto" (resolve_compaction calibrates it per checkpoint)
    ess_compaction: float = 0.0
    # the network family: "nerf" (coarse + fine MLPs), "kilonerf" (one
    # voxel-routed grid of tiny MLPs, ops/kilonerf.py, for both passes) or
    # "ngp" (Instant-NGP's network, models/ngp.py, one pass)
    network_type: str = "nerf"
    kilo_grid_size: int = 16
    kilo_hidden: int = 32
    kilo_capacity_factor: float = 2.0
    kilo_dispatch_rounds: int = 1
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
    # the hash box [-hash_bound, hash_bound]^3
    hash_bound: float = 2.0
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
    def kilonerf(self) -> bool:
        return self.network_type == "kilonerf"

    @property
    def ngp(self) -> bool:
        return self.network_type == "ngp"

    def ngp_shapes(self):
        """Instant-NGP's layers, (fan_in, fan_out) by MLP."""
        return ngp_model.layer_shapes(self.input_ch)

    @property
    def input_ch(self) -> int:
        if self.hashgrid:
            return self.hash_levels * self.hash_features
        return freq_out_dim(3, self.xyz_freqs)

    def model_shape(self) -> Dict[str, Any]:
        """The shapes ``train.checkpoint.load_params`` reads a model by
        (for Instant-NGP's network, its leaves' shapes under ``ngp``)."""
        if self.ngp:
            return dict(ngp=ngp_model.leaf_shapes(self.ngp_shapes(), table_shape(
                self.hash_levels, self.hash_features, self.hash_log2_size, self.hash_layout)))
        return dict(D=self.mlp_depth, W=self.mlp_width, input_ch=self.input_ch,
                    input_ch_views=self.input_ch_views, skips=self.skips,
                    use_viewdirs=self.use_viewdirs,
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
        KiloNeRF (``network_module: kilonerf``, its ``kilo`` node) and
        Instant-NGP's network (``network_module: ngp``: the hash-grid
        encoder, spherical-harmonics directions of degree 4, its published
        widths, ``N_importance`` 0). ``ess_compaction: auto`` becomes -1, as in the
        JAX package."""
        net = cfg.network
        module = str(cfg.get("network_module", "nerf"))
        if module not in ("nerf", "kilonerf", "ngp"):
            raise NotImplementedError(f"network_module {module!r} is not ported")
        kilo = cfg.get("kilo", {})
        xyz = net.xyz_encoder
        kind = xyz.get("type", "frequency")
        if kind not in ("frequency", "hashgrid", "grid_hash"):
            raise NotImplementedError(f"xyz encoder {kind!r} is not ported")
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
                hash_layout=str(xyz.get("layout", "corner")),
                hash_bound=float(xyz.get("bound", 2.0)))
        dirs = net.dir_encoder
        dir_kind = str(dirs.get("type", "frequency"))
        if dir_kind not in ("frequency", "sphere_harmonics"):
            raise NotImplementedError(f"dir encoder {dir_kind!r} is not ported")
        ta = cfg.task_arg
        if module == "ngp":
            if (kind == "frequency" or dir_kind != "sphere_harmonics"
                    or int(dirs.get("degree", ngp_model.SH_DEGREE)) != ngp_model.SH_DEGREE):
                raise ValueError("Instant-NGP's network takes the hash-grid xyz encoder and "
                                 "sphere_harmonics directions of degree 4")
            if int(ta.N_importance) != 0:
                raise ValueError("Instant-NGP's network renders one pass: N_importance must be 0")
        elif dir_kind != "frequency":
            raise NotImplementedError("sphere_harmonics directions are wired for "
                                      "network_module ngp only")
        return cls(
            **hash_kw,
            network_type=module,
            kilo_grid_size=int(kilo.get("grid_size", 16)),
            kilo_hidden=int(kilo.get("hidden", 32)),
            kilo_capacity_factor=float(kilo.get("capacity_factor", 2.0)),
            kilo_dispatch_rounds=int(kilo.get("dispatch_rounds", 1)),
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
            ess_compaction=(-1.0 if str(cfg.get("ess_compaction", 0.0)) == "auto"
                            else float(cfg.get("ess_compaction", 0.0))),
            xyz_freqs=int(net.xyz_encoder.get("freq", 10)),
            dir_freqs=int(dirs.get("freq", 4)),
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

    The CUDA kernels take bfloat16 or float32 weights (``check_weight_dtype``).
    A model the fused kernel does not cover (the hash grid, or a frequency
    NeRF of another shape, ``supports``) keeps its tree: float32 MLP leaves
    (and a hash-grid table in ``opts.hash_dtype``), as tensors on ``device``."""
    dev = torch.device(device)
    if opts.kilonerf:  # one float32 model for both passes, on the device once
        models: Dict[int, Dict] = {}
        return {name: models.setdefault(id(sub), tree_map(
                    lambda x: torch.as_tensor(x).detach().to(device=dev, dtype=torch.float32),
                    sub))
                for name, sub in tree.items()}
    if opts.hashgrid or not supports(opts):
        def leaf(x, dtype=torch.float32):
            return torch.as_tensor(x).detach().to(device=dev, dtype=dtype)

        out = {}
        for name, sub in tree.items():
            out[name] = tree_map(leaf, {k: v for k, v in sub.items() if k != "xyz_encoder"})
            if "xyz_encoder" in sub:
                out[name]["xyz_encoder"] = {"table": leaf(sub["xyz_encoder"]["table"],
                                                          _DTYPES[opts.hash_dtype])}
        return out
    check_weight_dtype(opts, dev)
    return {name: {k: v.to(dev) for k, v in repack_params(
                sub, opts.xyz_freqs, opts.dir_freqs, _DTYPES[opts.compute_dtype]).items()}
            for name, sub in tree.items()}


def check_weight_dtype(opts: RenderOptions, device: torch.device) -> None:
    """Raise for weights of a dtype that has no fused kernel
    (``fused_mlp.KERNEL_DTYPES``) on a CUDA device, unless
    ``opts.use_fused_mlp`` is off (the plain version) or the model does not
    go through the fused kernel (``supports``)."""
    if (device.type == "cuda" and opts.use_fused_mlp and not opts.hashgrid
            and not opts.kilonerf and supports(opts)
            and _DTYPES.get(opts.compute_dtype) not in KERNEL_DTYPES):
        names = " or ".join(str(d).replace("torch.", "") for d in KERNEL_DTYPES)
        raise NotImplementedError(
            f"the fused CUDA kernels take {names} weights, not {opts.compute_dtype}; set "
            "use_pallas_kernels False to run them through the plain version")


# points per hash-grid density evaluation: each point gathers L rows and
# keeps L x 8 float32 weights and products, ~0.2 KB a level at 16 levels
HASH_DENSITY_CHUNK = 1 << 18


def make_density_fn(kp: Dict[str, torch.Tensor], opts: RenderOptions
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """[M, 3] -> activated sigma of the MLP ``kp``, for grid rebuilds. Sigma
    does not depend on the view direction, so the directions are zeros (for
    a model queried in plain PyTorch, the hash grid or a frequency NeRF of
    another shape, a zero direction embedding, as the JAX package's trainer
    feeds it, evaluated in chunks of ``HASH_DENSITY_CHUNK`` points).

    KiloNeRF (``kp`` its l1..l5 leaves): one dispatch round with the
    capacity of the fullest network in the chunk (``no_drop_capacity``),
    so that no point is dropped. (The JAX package uses the default
    capacity here: a lattice slab of one x-plane lies in one column of
    networks, and a quarter of its points come back as density 0.)"""
    if opts.kilonerf:
        kcfg = kilo_config_from_opts(opts)

        def kilo_density(pts: torch.Tensor) -> torch.Tensor:
            raw = kilonerf_eval(kp, pts, torch.zeros_like(pts), kcfg,
                                capacity=no_drop_capacity(pts, kcfg))
            return density_activation(raw[:, 3], opts.sigma_activation)

        return kilo_density
    if opts.ngp:
        def ngp_density(pts: torch.Tensor) -> torch.Tensor:
            cd = _DTYPES[opts.compute_dtype]
            return torch.cat([density_activation(
                ngp_model.density_outputs(kp, _xyz_embed(kp, p, opts), cd)[:, 0],
                opts.sigma_activation) for p in pts.split(HASH_DENSITY_CHUNK)])

        return ngp_density
    if opts.hashgrid or not supports(opts):
        def mlp_density(pts: torch.Tensor) -> torch.Tensor:
            out = []
            for p in pts.split(HASH_DENSITY_CHUNK):
                emb = _xyz_embed(kp, p, opts)
                x = torch.cat([emb, emb.new_zeros(p.shape[0], opts.input_ch_views)], dim=-1)
                raw = apply_nerf_mlp(kp, x, opts.input_ch, opts.skips,
                                     _DTYPES[opts.compute_dtype], opts.use_viewdirs)
                out.append(density_activation(raw[:, 3], opts.sigma_activation))
            return torch.cat(out)

        return mlp_density

    fn = fused_nerf_eval if opts.use_fused_mlp else fused_nerf_eval_plain

    def density(pts: torch.Tensor) -> torch.Tensor:
        raw = fn(kp, pts.contiguous(), torch.zeros_like(pts))
        return density_activation(raw[:, 3], opts.sigma_activation)

    return density


def _xyz_embed(params, pts: torch.Tensor, opts: RenderOptions) -> torch.Tensor:
    """The points' encoding: the hash grid's over its box (span
    ``hash.encode``: the index arithmetic, the gather, the interpolation)
    or the frequency encoding."""
    if not opts.hashgrid:
        return freq_encode(pts, opts.xyz_freqs)
    with span("hash.encode"):
        return hashgrid_encode(params["xyz_encoder"], pts, bbox_min=-opts.hash_bound,
                               bbox_max=opts.hash_bound, base_resolution=opts.hash_base_res,
                               per_level_scale=opts.hash_scale, layout=opts.hash_layout,
                               plain=not opts.use_fused_mlp)


def query_mlp(params: Mapping[str, Any], pts: torch.Tensor, viewdirs: torch.Tensor,
              opts: RenderOptions) -> torch.Tensor:
    """pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4] of a model queried in
    plain PyTorch (the tree of ``init_nerf_params``/``kernel_params``): the
    points' encoding (``_xyz_embed``), the directions' frequency encoding,
    the MLP; the counterpart of ``nerf_tpu``'s ``query_network_xla``."""
    n, s, _ = pts.shape
    emb = _xyz_embed(params, pts.reshape(-1, 3), opts)
    if opts.use_viewdirs:
        dirs = viewdirs[:, None, :].expand(n, s, 3).reshape(-1, 3)
        emb = torch.cat([emb, freq_encode(dirs, opts.dir_freqs)], dim=-1)
    raw = apply_nerf_mlp(params, emb, opts.input_ch, opts.skips, _DTYPES[opts.compute_dtype],
                         opts.use_viewdirs)
    return raw.reshape(n, s, 4)


def query_ngp(params: Mapping[str, Any], pts: torch.Tensor, viewdirs: torch.Tensor,
              opts: RenderOptions) -> torch.Tensor:
    """pts [N, S, 3], unit viewdirs [N, 3] -> raw [N, S, 4] of Instant-NGP's
    network: the hash encoding of the points, the spherical harmonics of
    each ray's direction (once a ray), the density and colour MLPs."""
    n, s, _ = pts.shape
    emb = _xyz_embed(params, pts.reshape(-1, 3), opts)
    sh = ngp_model.dir_encoding(viewdirs)
    sh = sh[:, None, :].expand(n, s, sh.shape[-1]).reshape(n * s, -1)
    raw = ngp_model.apply_ngp(params, emb, sh, _DTYPES[opts.compute_dtype])
    return raw.reshape(n, s, 4)


def kilo_config_from_opts(opts: RenderOptions) -> KiloConfig:
    """The routed networks' config; their box is ``KiloConfig``'s [-2, 2]^3,
    as the JAX package's."""
    return KiloConfig(grid_size=opts.kilo_grid_size, hidden=opts.kilo_hidden,
                      xyz_freqs=opts.xyz_freqs, dir_freqs=opts.dir_freqs,
                      capacity_factor=opts.kilo_capacity_factor,
                      dispatch_rounds=opts.kilo_dispatch_rounds)


def query(params: Mapping[str, Any], pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
          opts: RenderOptions) -> torch.Tensor:
    """pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4] through the model's
    query: KiloNeRF's routed networks (zero directions when none are
    given), Instant-NGP's network (``query_ngp``), the fused kernel (or its
    plain version) for the shape it covers, else ``query_mlp``."""
    if opts.kilonerf:
        if viewdirs is None:
            viewdirs = pts.new_zeros(pts.shape[0], 3)
        return query_network_kilonerf(params, pts, viewdirs, kilo_config_from_opts(opts))
    if opts.ngp:
        return query_ngp(params, pts, viewdirs, opts)
    if opts.hashgrid or not supports(opts):
        return query_mlp(params, pts, viewdirs, opts)
    return query_network(params, pts, viewdirs, plain=not opts.use_fused_mlp,
                         xyz_freqs=opts.xyz_freqs, dir_freqs=opts.dir_freqs,
                         weight_dtype=_DTYPES[opts.compute_dtype])


def query_masked_compacted(params: Mapping[str, Any], pts: torch.Tensor,
                           viewdirs: torch.Tensor, opts: RenderOptions, mask: torch.Tensor,
                           cap: int) -> torch.Tensor:
    """pts [N, S, 3], viewdirs [N, 3], mask [N, S] -> raw [N, S, 4], querying
    only the masked points: kept point i goes to slot cumsum(mask)[i] - 1 of a
    [cap, 1, 3] batch with its own view direction. Points past the capacity
    and points left out read ``EMPTY_SIGMA_RAW`` (density exactly 0 under
    every activation); unfilled slots query point 0 and are never read.
    With cap >= N * S every point is queried, as by ``query``."""
    n, s, _ = pts.shape
    P = n * s
    if cap >= P:
        return query(params, pts, viewdirs, opts)
    flat_mask = mask.reshape(P)
    slot = torch.cumsum(flat_mask.to(torch.int64), 0) - 1
    keep = flat_mask & (slot < cap)
    kept = torch.nonzero(keep).squeeze(1)
    gather_idx = torch.zeros(cap, dtype=torch.int64, device=pts.device)
    gather_idx[slot[kept]] = kept
    dirs = viewdirs[:, None, :].expand(n, s, 3).reshape(P, 3)
    raw_c = query(params, pts.reshape(P, 3)[gather_idx][:, None, :], dirs[gather_idx],
                  opts).reshape(cap, 4)
    empty = torch.tensor([0.0, 0.0, 0.0, EMPTY_SIGMA_RAW], dtype=raw_c.dtype,
                         device=raw_c.device)
    raw = torch.where(keep[:, None], raw_c[slot.clamp(0, cap - 1)], empty)
    return raw.reshape(n, s, 4)


def compaction_capacity(n_points: int, fraction: float) -> int:
    """The compacted batch's size: ``fraction`` of the points, rounded up to
    a multiple of 256, at least 256."""
    cap = int(n_points * fraction)
    return max(256, ((cap + 255) // 256) * 256)


def fine_pass_mask(grid: occ.OccupancyGrid, pts_f: torch.Tensor) -> torch.Tensor:
    """[N, Sf] keep-mask of the fine pass: the sample's voxel is occupied.

    The JAX package's mask also drops samples where the coarse pass's
    transmittance, read after the preceding coarse sample, is below the ERT
    threshold. That is not a skip of samples the composite would zero: it
    reads T at the end of the preceding sample's interval, so it drops the
    fine samples inside the interval where the coarse ray turns opaque,
    which is where the fine pass puts them (800x800 lego frames at 21.6 and
    22.6 dB from the dense frames on an H100; read before that sample, 34.7
    and 36.3 dB, the coarse and fine surfaces differing;
    ``tools/compaction_masks.py``). The port keeps occupancy alone (59.7 and
    48.8 dB from dense: the grid's own cut)."""
    return occ.query(grid, pts_f.reshape(-1, 3)).reshape(pts_f.shape[:-1])


def calibrate_compaction(params: Mapping[str, Any], rays_o: torch.Tensor, rays_d: torch.Tensor,
                         opts: RenderOptions, grid: occ.OccupancyGrid,
                         generator: Optional[torch.Generator] = None, margin: float = 1.25,
                         disable_above: float = 0.30) -> float:
    """A compaction fraction for this checkpoint: the fine pass's kept rate
    on the probe rays times ``margin``, rounded up to what
    ``compaction_capacity`` allocates; 0 (off) when that reaches
    ``disable_above``, where the JAX package found the dense pass faster."""
    out = render_rays(params, rays_o, rays_d, dataclasses.replace(opts, ess_compaction=0.0),
                      grid=grid, generator=generator)
    if "fine_z_vals" not in out:
        return 0.0
    z_all = out["fine_z_vals"]
    pts_f = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., None]
    kept = float(fine_pass_mask(grid, pts_f).float().mean())
    n_pts = z_all.shape[0] * z_all.shape[1]
    frac = compaction_capacity(n_pts, min(1.0, margin * kept)) / n_pts
    return 0.0 if frac >= disable_above else frac


def resolve_compaction(opts: RenderOptions, params: Mapping[str, Any],
                       grid: Optional[occ.OccupancyGrid], rays_o: torch.Tensor,
                       rays_d: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> RenderOptions:
    """``ess_compaction: auto`` (-1) -> the fraction ``calibrate_compaction``
    measures on the probe rays (0 without an ESS grid); any other value is
    kept."""
    if opts.ess_compaction >= 0.0:
        return opts
    if grid is None or not opts.enable_ess:
        return dataclasses.replace(opts, ess_compaction=0.0)
    frac = calibrate_compaction(params, rays_o, rays_d, opts, grid, generator)
    print(f"# ess_compaction auto -> {frac:.3f} (calibrated)", flush=True)
    return dataclasses.replace(opts, ess_compaction=frac)


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
    otherwise ``no_grad`` and deterministic fine samples, and compaction
    where ``opts.ess_compaction`` > 0 and there is a grid (never in
    training: there the kept rate outgrows any fixed capacity, and dropped
    samples would carry no gradient)."""
    with contextlib.nullcontext() if train else torch.no_grad():
        return _render_rays(params, rays_o, rays_d, opts, grid, generator, train)


def _render_rays(params, rays_o, rays_d, opts: RenderOptions, grid, generator, train):
    with span("rays.sample"):  # the coarse samples (ESS's probe)
        if opts.enable_ess and grid is not None:
            z_vals = occ.sample_coarse_with_ess(
                grid, rays_o, rays_d, opts.n_samples, opts.near, opts.far,
                perturb=opts.perturb, lindisp=opts.lindisp, generator=generator)
        else:
            z_vals = sample_coarse(rays_o.shape[0], opts.n_samples, opts.near, opts.far,
                                   perturb=opts.perturb, lindisp=opts.lindisp,
                                   generator=generator, device=rays_o.device)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., None]
    raw = query(params["coarse"], pts, rays_d, opts)
    out_c = _composite(raw, z_vals.contiguous(), rays_d, opts, generator)
    ret = {"rgb_map_0": out_c["rgb_map"], "disp_map_0": out_c["disp_map"],
           "acc_map_0": out_c["acc_map"], "depth_map_0": out_c["depth_map"],
           "coarse_weights": out_c["weights"], "coarse_z_vals": z_vals}
    if opts.n_importance > 0:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        w_fine = out_c["weights"][..., 1:-1]
        if opts.detach_fine_sampling:
            z_mid, w_fine = z_mid.detach(), w_fine.detach()
        with span("rays.sample"):  # the fine samples, merged with the coarse
            z_fine = sample_pdf(z_mid, w_fine, opts.n_importance, deterministic=not train,
                                generator=generator)
            z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
        pts_f = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., None]
        if opts.enable_ess and grid is not None and opts.ess_compaction > 0.0 and not train:
            cap = compaction_capacity(z_all.shape[0] * z_all.shape[1], opts.ess_compaction)
            raw_f = query_masked_compacted(params["fine"], pts_f, rays_d, opts,
                                           fine_pass_mask(grid, pts_f), cap)
        else:
            raw_f = query(params["fine"], pts_f, rays_d, opts)
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
