"""What the benchmark imports: no JAX and no JAX package anywhere, and
nothing of the measured program in the reference."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.core.runner import BANNED_MODULES, banned_loaded

BENCH = Path(__file__).resolve().parent.parent
PORT = "geomapnet_tpu_torch"


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_imported(path):
    assert not _imports(path) & set(BANNED_MODULES)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert PORT not in names and "benchmark" not in names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.module in ("mapnet", "train", "compare", "poses",
                                   None), node.module


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import benchmark.reference.train, benchmark.reference.poses, "
            "benchmark.reference.compare; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            "{{'geomapnet_tpu_torch', 'geomapnet_tpu', 'jax'}}))"
            ).format(root=str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_banned_compares_whole_top_level_names():
    # the port's name begins with the JAX package's; only whole names count
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "sys.modules['geomapnet_tpu_torch_probe'] = sys; "
            "sys.modules['jax.numpy'] = sys; "
            "from benchmark.core.runner import banned_loaded; "
            "print(banned_loaded())").format(root=str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "['jax']"
