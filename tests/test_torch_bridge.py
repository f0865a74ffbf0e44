"""nerf_tpu_torch weight bridge against nerf_tpu's checkpoint reader.

Tolerances: the bridge copies float32 arrays, so every comparison is exact.
"""
import os

import jax
import numpy as np
import pytest
import torch

from nerf_tpu.render.renderer import RenderOptions as JaxRenderOptions
from nerf_tpu.train.checkpoint import load_params as jax_load_params
from nerf_tpu.train.loop import init_nerf_params

from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
from nerf_tpu_torch.train.checkpoint import from_jax_params, load_params

LEGO = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "nerf", "lego", "nerf")


@pytest.fixture(scope="module")
def lego_tree():
    return load_params(LEGO)


def test_load_params_matches_jax_all_leaves(lego_tree):
    template = init_nerf_params(jax.random.PRNGKey(0),
                                JaxRenderOptions(compute_dtype="float32"))
    want = jax.tree_util.tree_leaves(jax_load_params(LEGO, template))
    got = jax.tree_util.tree_leaves(lego_tree)
    assert len(got) == len(want) == 48
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name", ["coarse", "fine"])
def test_from_jax_params_round_trip(lego_tree, name):
    model = from_jax_params(lego_tree)[name]
    assert isinstance(model, NeRFMLP)
    back = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), model.to_tree()))
    for a, b in zip(back, jax.tree_util.tree_leaves(lego_tree[name])):
        np.testing.assert_array_equal(a, b)


def test_from_jax_params_of_fresh_jax_init():
    params = init_nerf_params(jax.random.PRNGKey(3), JaxRenderOptions())
    tree = jax.tree_util.tree_map(np.asarray, params)
    models = from_jax_params(tree)
    np.testing.assert_array_equal(models["fine"].pts_linears[5].weight.detach().numpy(),
                                  tree["fine"]["pts_linears"][5]["w"].T)
    assert models["coarse"].views_linears[0].in_features == 283


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path))


def test_wrong_leaf_shape_raises(tmp_path):
    np.savez(tmp_path / "latest.npz", **{f"leaf_{i}": np.zeros((2, 2), np.float32)
                                         for i in range(48)})
    with pytest.raises(ValueError, match="leaf_0"):
        load_params(str(tmp_path))


def test_nerf_mlp_init_is_seeded():
    a = NeRFMLP(generator=torch.Generator().manual_seed(5))
    b = NeRFMLP(generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a.pts_linears[3].weight, b.pts_linears[3].weight,
                               rtol=0, atol=0)
    bound = 1 / 256 ** 0.5
    assert float(a.pts_linears[3].weight.detach().abs().max()) <= bound
