"""The classic NeRF MLP as an ``nn.Module``; counterpart of ``nerf_tpu/models/nerf_mlp.py``.

8x256 ``pts_linears`` with the embedded input concatenated after layer 4's
ReLU, and the view-direction head (alpha_linear 256->1, feature_linear
256->256, views_linears [256+27 -> 128], rgb_linear 128->3); without view
directions one ``output_linear`` W->4 instead. The output is
[rgb_raw(3), sigma_raw(1)].

The layers are ``nn.Linear`` (weights [out, in]). The bridge to the JAX
layout ([in, out], ``to_tree``/``from_tree``) transposes.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

Tree = Dict[str, Any]


def _linear(fan_in: int, fan_out: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """nn.Linear with the U(-1/sqrt(fan_in), 1/sqrt(fan_in)) init of both
    weight and bias (torch's default, and ``nerf_tpu``'s), drawn from an
    explicit generator."""
    layer = nn.Linear(fan_in, fan_out)
    bound = 1.0 / fan_in ** 0.5
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def linear_init(generator: Optional[torch.Generator], fan_in: int, fan_out: int,
                device=None) -> Dict[str, torch.Tensor]:
    """The counterpart of ``nerf_tpu``'s ``_linear_init``: {"w": [in, out],
    "b": [out]} float32, both U(-1/sqrt(fan_in), 1/sqrt(fan_in)), w drawn
    first, from ``generator``, on ``device``."""
    bound = 1.0 / fan_in ** 0.5
    w = torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=generator)
    b = torch.empty(fan_out).uniform_(-bound, bound, generator=generator)
    return {"w": w.to(device), "b": b.to(device)}


def dense(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """``h @ weight.T + bias`` with operands rounded to ``compute_dtype`` and
    the products summed in float32 (bf16 products are exact in float32)."""
    return F.linear(h.to(compute_dtype).float(), weight.to(compute_dtype).float()) + bias.float()


class NeRFMLP(nn.Module):
    def __init__(self, D: int = 8, W: int = 256, input_ch: int = 63,
                 input_ch_views: int = 27, skips: Sequence[int] = (4,),
                 generator: Optional[torch.Generator] = None, use_viewdirs: bool = True):
        super().__init__()
        self.input_ch = input_ch
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        layers = []
        in_dim = input_ch
        for i in range(D):
            layers.append(_linear(in_dim, W, generator))
            in_dim = W + input_ch if i in self.skips else W
        self.pts_linears = nn.ModuleList(layers)
        if not use_viewdirs:
            self.output_linear = _linear(W, 4, generator)
            return
        self.feature_linear = _linear(W, W, generator)
        self.alpha_linear = _linear(W, 1, generator)
        self.views_linears = nn.ModuleList([_linear(input_ch_views + W, W // 2, generator)])
        self.rgb_linear = _linear(W // 2, 3, generator)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """x: [..., input_ch + input_ch_views] -> [..., 4] float32 (plain
        reference of ``apply_nerf_mlp``)."""
        def lin(layer, h):
            return dense(h, layer.weight, layer.bias, compute_dtype)

        input_pts = x[..., : self.input_ch]
        input_views = x[..., self.input_ch:]
        h = input_pts
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(lin(layer, h))
            if i in self.skips:
                h = torch.cat([input_pts, h], dim=-1)
        if not self.use_viewdirs:
            return lin(self.output_linear, h)
        alpha = lin(self.alpha_linear, h)
        h = torch.cat([lin(self.feature_linear, h), input_views], dim=-1)
        for layer in self.views_linears:
            h = torch.relu(lin(layer, h))
        return torch.cat([lin(self.rgb_linear, h), alpha], dim=-1)

    def to_tree(self) -> Tree:
        """The JAX params pytree layout: {name: {"w": [in, out], "b": [out]}}."""
        def t(layer):
            return {"w": layer.weight.detach().t(), "b": layer.bias.detach()}

        if not self.use_viewdirs:
            return {"pts_linears": [t(l) for l in self.pts_linears],
                    "output_linear": t(self.output_linear)}
        return {
            "pts_linears": [t(l) for l in self.pts_linears],
            "feature_linear": t(self.feature_linear),
            "alpha_linear": t(self.alpha_linear),
            "views_linears": [t(l) for l in self.views_linears],
            "rgb_linear": t(self.rgb_linear),
        }

    @classmethod
    def from_tree(cls, tree: Mapping[str, Any], skips: Sequence[int] = (4,)) -> "NeRFMLP":
        """Build from a JAX-layout pytree of arrays (numpy or tensors)."""
        pts = tree["pts_linears"]
        W = np.shape(pts[0]["w"])[1]
        input_ch = np.shape(pts[0]["w"])[0]
        use_viewdirs = "views_linears" in tree
        input_ch_views = np.shape(tree["views_linears"][0]["w"])[0] - W if use_viewdirs else 0
        model = cls(D=len(pts), W=W, input_ch=input_ch,
                    input_ch_views=input_ch_views, skips=skips, use_viewdirs=use_viewdirs)

        def load(layer, leaf):
            w = torch.tensor(np.asarray(leaf["w"], np.float32))
            b = torch.tensor(np.asarray(leaf["b"], np.float32))
            if tuple(w.shape) != (layer.in_features, layer.out_features):
                raise ValueError(f"weight shape {tuple(w.shape)} does not fit "
                                 f"({layer.in_features}, {layer.out_features})")
            with torch.no_grad():
                layer.weight.copy_(w.t())
                layer.bias.copy_(b.reshape(-1))

        for layer, leaf in zip(model.pts_linears, pts):
            load(layer, leaf)
        if not use_viewdirs:
            load(model.output_linear, tree["output_linear"])
            return model
        for name in ("feature_linear", "alpha_linear", "rgb_linear"):
            load(getattr(model, name), tree[name])
        for layer, leaf in zip(model.views_linears, tree["views_linears"]):
            load(layer, leaf)
        return model


def apply_nerf_mlp(params: Mapping[str, Any], x: torch.Tensor, input_ch: int,
                   skips: Sequence[int] = (4,), compute_dtype: torch.dtype = torch.float32,
                   use_viewdirs: bool = True) -> torch.Tensor:
    """The counterpart of ``nerf_tpu``'s ``apply_nerf_mlp`` on a JAX-layout
    tree (weights [in, out]) of any depth, width and skips, with the view
    head (or, without view directions, ``output_linear`` [W, 4]): x [...,
    input_ch + input_ch_views] -> [..., 4] float32. Each product rounds its
    operands to ``compute_dtype`` and sums in float32 (``dense``). The
    hash-grid model and every frequency NeRF but the lego shape run their
    MLP here: the JAX package leaves them to XLA, not to a Pallas kernel."""
    def lin(p, h):
        return dense(h, p["w"].t(), p["b"], compute_dtype)

    input_pts, input_views = x[..., :input_ch], x[..., input_ch:]
    h = input_pts
    for i, layer in enumerate(params["pts_linears"]):
        h = torch.relu(lin(layer, h))
        if i in skips:
            h = torch.cat([input_pts, h], dim=-1)
    if not use_viewdirs:
        return lin(params["output_linear"], h)
    alpha = lin(params["alpha_linear"], h)
    h = torch.cat([lin(params["feature_linear"], h), input_views], dim=-1)
    for layer in params["views_linears"]:
        h = torch.relu(lin(layer, h))
    return torch.cat([lin(params["rgb_linear"], h), alpha], dim=-1)


def init_nerf_mlp(generator: Optional[torch.Generator] = None, D: int = 8, W: int = 256,
                  input_ch: int = 63, input_ch_views: int = 27, skips: Sequence[int] = (4,),
                  device: Optional[torch.device] = None, use_viewdirs: bool = True) -> Tree:
    """The counterpart of ``nerf_tpu``'s ``init_nerf_mlp``: a JAX-layout tree
    (weights [in, out]) with U(+-1/sqrt(fan_in)) weights and biases drawn from
    ``generator``; float32 contiguous leaves on ``device`` that require grad.
    Without view directions the heads are one ``output_linear`` [W, 4]."""
    mlp = NeRFMLP(D=D, W=W, input_ch=input_ch, input_ch_views=input_ch_views, skips=skips,
                  generator=generator, use_viewdirs=use_viewdirs)

    def leaf(x):
        return x.contiguous().to(device).requires_grad_(True)

    return {k: [{n: leaf(x) for n, x in d.items()} for d in v] if isinstance(v, list)
            else {n: leaf(x) for n, x in v.items()} for k, v in mlp.to_tree().items()}


def _f32(value) -> torch.Tensor:
    """A tensor or array as a float32 CPU tensor, values unchanged."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(value, np.float32))


def load_torch_state_dict(state_dict: Mapping[str, Any], D: int = 8,
                          use_viewdirs: bool = True) -> Tree:
    """The counterpart of ``nerf_tpu``'s ``load_torch_state_dict``: a torch
    ``NeRF`` state_dict (the reference's ``network.py:9``; weights [out, in])
    -> the JAX-layout tree (weights transposed to [in, out]) of contiguous
    float32 CPU tensors."""
    def lin(name):
        return {"w": _f32(state_dict[f"{name}.weight"]).t().contiguous(),
                "b": _f32(state_dict[f"{name}.bias"])}

    params: Tree = {"pts_linears": [lin(f"pts_linears.{i}") for i in range(D)]}
    if use_viewdirs:
        params["feature_linear"] = lin("feature_linear")
        params["alpha_linear"] = lin("alpha_linear")
        params["views_linears"] = [lin("views_linears.0")]
        params["rgb_linear"] = lin("rgb_linear")
    else:
        params["output_linear"] = lin("output_linear")
    return params


def load_weights_from_keras(weights: Sequence[Any], D: int = 8,
                            use_viewdirs: bool = True) -> Tree:
    """The counterpart of ``nerf_tpu``'s ``load_weights_from_keras``: the
    original TF-NeRF keras weight list ([kernel, bias] pairs of
    pts_linears[0..D-1], feature_linear, views_linears[0], rgb_linear,
    alpha_linear) -> the JAX-layout tree of float32 CPU tensors. Keras
    kernels are [in, out] already, so they go in untransposed."""
    if not use_viewdirs:
        raise ValueError("original TF-NeRF keras checkpoints are viewdir models")

    def pair(idx):
        return {"w": _f32(weights[2 * idx]), "b": _f32(weights[2 * idx + 1])}

    return {"pts_linears": [pair(i) for i in range(D)], "feature_linear": pair(D),
            "views_linears": [pair(D + 1)], "rgb_linear": pair(D + 2),
            "alpha_linear": pair(D + 3)}
