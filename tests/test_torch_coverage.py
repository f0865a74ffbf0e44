"""The port does all that the JAX package does: an AST walk of ``nerf_tpu/``.

Every module of ``nerf_tpu`` has a counterpart in ``nerf_tpu_torch`` (the
same path; ``config/`` is the port's ``config.py``), and every public
top-level function and class of a module has a same-named counterpart in
the port's module, or stands in ``ELSEWHERE`` with the reason and the
port's name that does its work there. A JAX name in neither fails; an
entry of ``ELSEWHERE`` whose name the port's module now has, or whose
stated counterpart is gone, fails too, so the list stays true.
"""
import ast
import os

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MODULE_MAP = {"nerf_tpu/config/__init__.py": "nerf_tpu_torch/config.py",
              "nerf_tpu/config/config.py": "nerf_tpu_torch/config.py"}

# (JAX module, name) -> (reason, the port's "module:name" that does the work)
ELSEWHERE = {
    ("nerf_tpu/ops/fused_mlp.py", "query_network_pallas"):
        ("Pallas wrapper of B1", "nerf_tpu_torch/ops/fused_mlp.py:fused_nerf_eval"),
    ("nerf_tpu/ops/integrate.py", "integrate_pallas"):
        ("Pallas wrapper of B3", "nerf_tpu_torch/ops/integrate.py:integrate"),
    ("nerf_tpu/ops/integrate.py", "composite_pallas"):
        ("Pallas wrapper of B3 with its VJP", "nerf_tpu_torch/ops/integrate.py:composite_kernel"),
    ("nerf_tpu/ops/hash_gather.py", "gather_rows_pallas"):
        ("Pallas wrapper of B4", "nerf_tpu_torch/ops/hash_gather.py:gather_rows"),
    ("nerf_tpu/ops/kilonerf.py", "distill_step"):
        ("in train/distill.py", "nerf_tpu_torch/train/distill.py:distill_step"),
    ("nerf_tpu/data/blender.py", "make_dataset"):
        ("in data/__init__.py", "nerf_tpu_torch/data/__init__.py:make_dataset"),
    ("nerf_tpu/parallel/mesh.py", "make_mesh"):
        ("jax.sharding mesh; the port's data group", "nerf_tpu_torch/parallel/mesh.py:data_group"),
    ("nerf_tpu/parallel/multihost.py", "fully_replicated_host_local"):
        ("jax.Array to host numpy; a rank's tensors are host-local already, copied by "
         "tree_map", "nerf_tpu_torch/tree.py:tree_map"),
    ("nerf_tpu/render/renderer.py", "get_query_fn"):
        ("XLA/Pallas query dispatch; one query function",
         "nerf_tpu_torch/render/renderer.py:query"),
    ("nerf_tpu/render/renderer.py", "query_network_xla"):
        ("the MLP in XLA; the port's plain MLP", "nerf_tpu_torch/render/renderer.py:query_mlp"),
    ("nerf_tpu/render/renderer.py", "query_with_compaction"):
        ("static-capacity compaction for XLA",
         "nerf_tpu_torch/render/renderer.py:query_masked_compacted"),
}


def _port_module(jax_path):
    return MODULE_MAP.get(jax_path, jax_path.replace("nerf_tpu/", "nerf_tpu_torch/", 1))


def _public(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read(), path)
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _defined(path):
    """Top-level names a module binds: defs, classes, assignments, imports."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read(), path)
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return names


JAX_MODULES = sorted(os.path.relpath(os.path.join(d, f), ROOT)
                     for d, _, fs in os.walk(os.path.join(ROOT, "nerf_tpu"))
                     for f in fs if f.endswith(".py"))
JAX_NAMES = sorted((m, n) for m in JAX_MODULES for n in _public(m))


def test_the_walk_finds_the_package():
    assert len(JAX_MODULES) > 50 and "nerf_tpu/utils/data_utils.py" in JAX_MODULES
    assert len(JAX_NAMES) > 250


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_module_has_a_counterpart(module):
    assert os.path.exists(os.path.join(ROOT, _port_module(module))), _port_module(module)


@pytest.mark.parametrize("module", sorted({m for m, _ in JAX_NAMES}))
def test_every_public_name_has_a_counterpart(module):
    port = _defined(_port_module(module))
    missing = [n for n in sorted(_public(module))
               if n not in port and (module, n) not in ELSEWHERE]
    assert not missing, f"{module}: no counterpart in {_port_module(module)} for {missing}"


@pytest.mark.parametrize("key", sorted(ELSEWHERE), ids=lambda k: f"{k[0]}:{k[1]}")
def test_every_exemption_is_still_true(key):
    module, name = key
    reason, where = ELSEWHERE[key]
    assert reason and name in _public(module), "the JAX name is gone"
    assert name not in _defined(_port_module(module)), "the port has it now: drop the entry"
    path, port_name = where.split(":")
    assert port_name in _defined(path), where
