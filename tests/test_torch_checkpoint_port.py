"""Reference PyTorch checkpoints through the port (``nerf_tpu_torch/utils/torch_port.py``,
``models/nerf_mlp.load_torch_state_dict`` / ``load_weights_from_keras`` and
``python -m nerf_tpu_torch.port_torch_checkpoint``) against the JAX package's.

- A reference-format ``.pth`` built in the test from ``tests/oracle_torch.py``
  (as ``tests/test_checkpoint_port.py`` does), plain and behind DDP's
  ``module.``: the port's tree equals JAX's ``load_reference_checkpoint``'s,
  bit for bit, and drives the MLP to the oracle's outputs (1e-5, as there).
- The ``latest.npz`` the port's CLI writes equals the one JAX's
  ``scripts/port_torch_checkpoint.py`` writes, leaf for leaf and bit for
  bit, and renders the same rays in the port and in JAX's ``run`` (perturb
  0, float32: colours and opacity 1e-4, as ``tests/test_torch_render.py``).
- The committed lego model written out as a reference ``.pth`` and ported
  back gives its own weights bit for bit.
- The keras list of ``tests/test_checkpoint_port.py`` goes in untransposed,
  equal to JAX's tree bit for bit.
"""
import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_torch as oracle
import run as jax_run
from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.models.nerf_mlp import load_weights_from_keras as jax_keras
from nerf_tpu.render import renderer as jrend
from nerf_tpu.utils import torch_port as jport

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.models.nerf_mlp import apply_nerf_mlp, load_weights_from_keras
from nerf_tpu_torch.port_torch_checkpoint import main as port_main
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.run import load_eval_model
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.train import checkpoint
from nerf_tpu_torch.tree import tree_leaves
from nerf_tpu_torch.utils import torch_port

ROOT = os.path.join(os.path.dirname(__file__), "..")
LEGO_CFG = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")


def _reference_pth(path, seed=0, ddp=False, **extra):
    torch.manual_seed(seed)
    nets = {"model.": oracle.OracleNeRF(), "model_fine.": oracle.OracleNeRF()}
    sd = {("module." if ddp else "") + prefix + k: v for prefix, m in nets.items()
          for k, v in m.state_dict().items()}
    torch.save({"net": sd, "epoch": 41, "optim": {"state": {}, "param_groups": [{"lr": 5e-4}]},
                "recorder": {"step": 3}, **extra}, path)
    return nets


def _same_tree(got, want):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("ddp", [False, True])
def test_reference_pth_gives_jax_s_tree_bit_for_bit(tmp_path, ddp):
    path = str(tmp_path / "latest.pth")
    nets = _reference_pth(path, ddp=ddp)
    got, want = torch_port.load_reference_checkpoint(path), jport.load_reference_checkpoint(path)
    for name in ("coarse", "fine"):
        _same_tree(got[name], want[name])
    x = np.random.RandomState(0).randn(8, 90).astype(np.float32)
    out = apply_nerf_mlp(got["fine"], torch.from_numpy(x), input_ch=63)
    with torch.no_grad():
        np.testing.assert_allclose(out.numpy(), nets["model_fine."](torch.from_numpy(x)).numpy(),
                                   atol=1e-5)


def test_strip_prefix_matches_jax():
    sd = {"module.model.a": 1, "module.model_fine.b": 2, "other": 3}
    for prefix in ("module.", "module.model.", "x"):
        assert torch_port.strip_prefix(sd, prefix) == jport.strip_prefix(sd, prefix)


def test_a_pth_that_pickles_other_objects_is_refused(tmp_path):
    path = str(tmp_path / "odd.pth")
    _reference_pth(path, extra_object=pickle.loads(pickle.dumps(range(3))))
    with pytest.raises(pickle.UnpicklingError):
        torch_port.load_reference_checkpoint(path)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_cli_writes_jax_s_npz_and_it_renders_as_jax(tmp_path, capsys):
    path = str(tmp_path / "ref.pth")
    _reference_pth(path, seed=3)
    over = ["network.dtype", "float32", "task_arg.perturb", "0", "enable_ess", "False"]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_main(["--cfg_file", LEGO_CFG, path, "trained_model_dir", port_dir, *over]) == 41
    assert "(epoch 41)" in capsys.readouterr().out
    _jax_script("port_torch_checkpoint").main(["--cfg_file", LEGO_CFG, path,
                                               "trained_model_dir", jax_dir, *over])
    with np.load(os.path.join(port_dir, "latest.npz")) as a, \
            np.load(os.path.join(jax_dir, "latest.npz")) as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 98 + 49
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    cfg = make_cfg(LEGO_CFG, ["trained_model_dir", port_dir, *over])
    opts, params, grid = load_eval_model(cfg, torch.device("cpu"))
    assert grid is None
    jcfg = jax_make_cfg(LEGO_CFG, ["trained_model_dir", port_dir, *over])
    jopts = jrend.RenderOptions.from_cfg(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_run._load_eval_params(jcfg, jopts))
    rng = np.random.default_rng(4)
    pose = look_at_pose(0.7, 0.3, 4.0)
    d = rng.normal(size=(96, 3)).astype(np.float32) * 0.2 - pose[:3, 2]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(pose[:3, 3], d.shape).astype(np.float32)
    want = jrend.render_rays(jparams, jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(0),
                             jopts, None)
    got = renderer.render_rays(params, torch.from_numpy(o), torch.from_numpy(d), opts)
    for k in ("rgb_map_0", "rgb_map", "acc_map_0", "acc_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


def test_the_committed_model_round_trips_through_a_reference_pth(tmp_path):
    opts = renderer.RenderOptions.from_cfg(make_cfg(LEGO_CFG))
    tree = checkpoint.load_params(LEGO, **opts.model_shape())
    path = str(tmp_path / "lego.pth")
    torch.save({"net": torch_port.reference_state_dict(tree), "epoch": 49}, path)
    out = str(tmp_path / "ported")
    assert port_main(["--cfg_file", LEGO_CFG, path, "trained_model_dir", out]) == 49
    back = checkpoint.load_params(out, **opts.model_shape())
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert torch_port.reference_state_dict(tree).keys() == \
        oracle_keys()


def oracle_keys():
    m = oracle.OracleNeRF()
    return {p + k for p in ("model.", "model_fine.") for k in m.state_dict()}


def test_a_config_of_another_shape_is_refused(tmp_path):
    path = str(tmp_path / "ref.pth")
    _reference_pth(path)
    with pytest.raises(ValueError, match="first layer"):
        port_main(["--cfg_file", LEGO_CFG, path, "trained_model_dir", str(tmp_path / "o"),
                   "network.xyz_encoder.freq", "6"])
    with pytest.raises(SystemExit):
        port_main(["--cfg_file", LEGO_CFG])


def test_keras_weights_go_in_untransposed_as_jax():
    rng = np.random.RandomState(0)
    D, W, in_ch, in_views = 8, 32, 63, 27
    dims = [(in_ch if i == 0 else (W + in_ch if i == 5 else W), W) for i in range(D)]
    dims += [(W, W), (W + in_views, W // 2), (W // 2, 3), (W, 1)]
    weights = []
    for fi, fo in dims:
        weights += [rng.randn(fi, fo).astype(np.float32), rng.randn(fo).astype(np.float32)]
    got, want = load_weights_from_keras(weights, D=D), jax_keras(weights, D=D)
    np.testing.assert_array_equal(got["pts_linears"][0]["w"].numpy(), weights[0])
    np.testing.assert_array_equal(got["alpha_linear"]["w"].numpy(), weights[2 * (D + 3)])
    assert set(got) == set(want)
    _same_tree(got, want)
    x = rng.randn(5, in_ch + in_views).astype(np.float32)
    out = apply_nerf_mlp(got, torch.from_numpy(x), input_ch=in_ch, skips=(4,))
    assert out.shape == (5, 4) and torch.isfinite(out).all()
    with pytest.raises(ValueError):
        load_weights_from_keras(weights, D=D, use_viewdirs=False)
