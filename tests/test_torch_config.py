"""The port's config (``nerf_tpu_torch.config``) against ``nerf_tpu.config``.

- Every yaml under ``configs/``, bare and with the exp-name overrides
  (``exp_name_tag``, ``gitbranch``, ``gitcommit``, ``bbox``): the same
  ``exp_name``, ``bbox``, ``trained_model_dir``, ``record_dir`` and
  ``result_dir``, and the same tree on the keys both defaults have (the
  port's defaults are those of ``nerf_tpu`` that it reads).
- ``Config``: dicts inside lists and tuples wrapped, ``get_path``,
  ``to_dict``; ``parse_args`` with ``nerf_tpu``'s flags.
- Every CLI of the port that takes ``--cfg_file`` builds its config
  through ``make_cfg`` (an AST scan), so each applies the exp-name rules.
"""
import ast
import glob
import os

import pytest

from nerf_tpu import config as jcfg
from nerf_tpu_torch import config as tcfg

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
YAMLS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "configs", "**",
                                                                         "*.yaml"),
                                                           recursive=True))
OVERRIDES = {
    "bare": [],
    "tag_and_bbox": ["exp_name", "e1", "exp_name_tag", "v2", "bbox", "[-1,-1,-1,1,2,3]"],
    "gitcommit": ["exp_name", "run_gitcommit"],
    "gitbranch": ["exp_name", "gitbranch_x", "exp_name_tag", "t"],
    "workspace": ["workspace", "ws", "scene", "chair", "bbox", "[0,0,0,1,1,1]"],
    "set_dir": ["exp_name", "e_gitcommit", "record_dir", "rec"],
}
DERIVED = ("exp_name", "bbox", "trained_model_dir", "record_dir", "result_dir")


def _common(a, b, path=""):
    """Paths where the two trees, on the keys both have, differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in a.keys() & b.keys() for d in _common(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _common(x, y, f"{path}[{i}]")]
    return [] if a == b and type(a) is type(b) else [path]


def test_every_yaml_is_listed():
    assert len(YAMLS) == 14 and "configs/nerf/lego.yaml" in YAMLS


@pytest.mark.parametrize("opts", sorted(OVERRIDES))
@pytest.mark.parametrize("yaml_file", YAMLS)
def test_make_cfg_matches_jax(yaml_file, opts, monkeypatch):
    monkeypatch.chdir(ROOT)
    want = jcfg.make_cfg(yaml_file, list(OVERRIDES[opts]))
    got = tcfg.make_cfg(yaml_file, list(OVERRIDES[opts]))
    for key in DERIVED:
        assert got.get(key) == want.get(key), key
    assert not _common(got, want)
    assert "gitcommit" not in got.exp_name and "gitbranch" not in got.exp_name


def test_the_exp_name_rules(monkeypatch):
    """The two command lines that showed the fault: the port now names
    JAX's directories."""
    monkeypatch.chdir(ROOT)
    cfg = tcfg.make_cfg("configs/nerf/lego.yaml", OVERRIDES["tag_and_bbox"])
    assert cfg.trained_model_dir == os.path.join("workspace", "trained_model", "nerf", "lego",
                                                 "e1_v2")
    assert cfg.bbox == [-2.0, -1.5, -1.0, 2.0, 2.5, 3.0]
    commit = tcfg._git_describe("--tags --always") or "nocommit"
    cfg = tcfg.make_cfg("configs/nerf/lego.yaml", ["exp_name", "run_gitcommit"])
    assert cfg.exp_name == f"run_{commit}"
    assert cfg.result_dir == os.path.join("workspace", "result", "nerf", "lego", f"run_{commit}")


def test_no_git_gives_the_fallbacks(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # not a git checkout: git describe prints nothing
    for mod in (jcfg, tcfg):
        cfg = mod.make_cfg(None, ["exp_name", "gitbranch-gitcommit"])
        assert cfg.exp_name == "nobranch-nocommit"


@pytest.mark.parametrize("mod", [jcfg, tcfg], ids=["jax", "port"])
def test_config_wraps_dicts_in_lists(mod):
    c = mod.Config({"a": {"b": 1}, "c": [1, {"d": 2}], "t": (3, {"u": [{"v": 4}]})})
    assert c.c[1].d == 2 and c.t[1].u[0].v == 4
    assert isinstance(c.t, tuple)
    c.a.e = 3
    c.w = [{"x": 5}]
    assert c["a"]["e"] == 3 and c.w[0].x == 5
    assert c.get_path("a.b") == 1 and c.get_path("a.z", "no") == "no"
    assert c.get_path("c.1") is None  # a list is not walked by name


def test_config_api_matches_jax():
    tree = {"a": {"b": 1}, "c": [1, {"d": 2}], "t": (3, {"u": 4}), "k": "v"}
    got, want = tcfg.Config(tree, extra=7), jcfg.Config(tree, extra=7)
    assert got.to_dict() == want.to_dict()
    assert type(got.to_dict()["c"][1]) is dict and type(got.to_dict()["t"]) is list
    for path in ("a.b", "a", "c", "t", "k", "missing", "a.b.c", "extra"):
        assert got.get_path(path) == want.get_path(path), path
    got.set_path("x.y.z", 3)
    want.set_path("x.y.z", 3)
    assert got.to_dict() == want.to_dict()
    assert got.clone().to_dict() == got.to_dict()


@pytest.mark.parametrize("argv", [
    [],
    ["--cfg_file", "configs/nerf/lego.yaml"],
    ["--cfg_file", "configs/nerf/lego.yaml", "--test", "--type", "evaluate", "--det", "d",
     "exp_name", "e", "exp_name_tag", "t", "train.lr", "1e-3"],
    ["--type", "network", "task_arg.N_rays", "512", "bbox", "[0,0,0,2,1,1]"],
])
def test_parse_args_matches_jax(argv, monkeypatch):
    monkeypatch.chdir(ROOT)
    got_cfg, got = tcfg.parse_args(list(argv))
    want_cfg, want = jcfg.parse_args(list(argv))
    assert vars(got) == vars(want)
    for key in DERIVED:
        assert got_cfg.get(key) == want_cfg.get(key), key
    assert not _common(got_cfg, want_cfg)


def _calls(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read(), path)
    return {getattr(n.func, "id", getattr(n.func, "attr", "")) for n in ast.walk(tree)
            if isinstance(n, ast.Call)}


# modules that take --cfg_file; performance_test hands it to ess_ert's subprocesses
CLI_FORWARDS = {"nerf_tpu_torch/performance_test.py": "nerf_tpu_torch/ess_ert.py"}
CFG_CLIS = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(os.path.join(ROOT, "nerf_tpu_torch")) for f in fs
    if f.endswith(".py") and '"--cfg_file"' in open(os.path.join(d, f)).read()
    and f != "config.py")


def test_the_clis_are_found():
    assert len(CFG_CLIS) >= 10 and "nerf_tpu_torch/serve.py" in CFG_CLIS


@pytest.mark.parametrize("path", CFG_CLIS)
def test_every_cli_goes_through_make_cfg(path):
    assert "make_cfg" in _calls(CLI_FORWARDS.get(path, path)), path
    assert "load_cfg" not in _calls(path), path
