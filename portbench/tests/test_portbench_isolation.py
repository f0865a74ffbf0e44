"""What runs on the card imports neither JAX nor the JAX package, the
reference nothing of the program, and the command refuses a machine
without a card (CPU)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "nerf_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = sorted((HERE / "reference").rglob("*.py"))


def top_level_imports(path: Path):
    """The top-level names of a file's absolute imports, and its relative
    imports resolved to dotted names."""
    tree = ast.parse(path.read_text())
    pkg = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-1])
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                out.add(".".join(base + ([node.module] if node.module else [])))
            else:
                out.add(node.module)
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    names = {n.split(".")[0] for n in top_level_imports(path)}
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "contextlib", "dataclasses", "itertools", "typing", "struct", "zlib",
               "numpy", "torch"}
    for name in top_level_imports(path):
        if name.startswith("portbench."):
            assert name.startswith("portbench.reference"), f"{path} imports {name}"
        else:
            assert name.split(".")[0] in allowed, f"{path} imports {name}"


def test_reference_loads_alone():
    code = ("import sys; import portbench.reference.nerf, portbench.reference.png, "
            "portbench.counts.b1, portbench.counts.b2, portbench.counts.b4; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('nerf_tpu_torch', 'nerf_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("nerf_tpu_torch", "nerf_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == sorted(
        m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    monkeypatch.setitem(sys.modules, "nerf_tpu.models", sys)
    assert "nerf_tpu.models" in harness.forbidden_modules()


def test_the_command_refuses_a_machine_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "lego.train",
                        "--seed", "4294967311", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr
