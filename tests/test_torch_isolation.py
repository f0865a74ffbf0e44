"""nerf_tpu_torch and chip_smoke.py import neither JAX nor nerf_tpu (AST scan)."""
import ast
import os

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FILES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(os.path.join(ROOT, "nerf_tpu_torch")) for f in fs
    if f.endswith(".py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "nerf_tpu")


def _imported_modules(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_port_has_modules():
    assert len(FILES) > 10 and "nerf_tpu_torch/serve.py" in FILES


@pytest.mark.parametrize("path", FILES)
def test_no_jax_and_no_nerf_tpu(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
