"""What the benchmark may import: no module of ``portbench`` imports JAX
or the JAX package (compared by the whole top-level name, since the port's
name begins with the JAX package's), nor ``chip_smoke``; the reference
imports nothing of the program either."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "stoch_gpmp_tpu", "chip_smoke"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_apart_from_the_program(path):
    assert "stoch_gpmp_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) - {"__future__", "math", "numpy", "torch", "portbench"}


def test_the_top_level_name_is_compared_whole():
    from portbench.harness import FORBIDDEN

    assert "stoch_gpmp_tpu" in FORBIDDEN
    assert "stoch_gpmp_tpu_torch".split(".")[0] not in FORBIDDEN


def test_a_run_loads_no_jax():
    import subprocess
    import sys

    code = ("import time, torch\n"
            "from portbench import harness\n"
            "from portbench.tests.helpers import run\n"
            "run('planar-env.demo', 11, 0.5, 'cpu')\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT.parent, timeout=600, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
