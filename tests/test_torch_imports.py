"""The port stands alone: no module of ikflow_tpu_torch/, not chip_smoke.py and
not bf16_flow_draws.py imports jax or the JAX package (checked on the source,
by AST walk)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ikflow_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "bf16_flow_draws.py"]
FORBIDDEN = {"jax", "jaxlib", "ikflow_tpu"}


def _imported_roots(source: str):
    """Top-level names of every absolute import, including __import__ and
    importlib.import_module calls with a literal name."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", None)) in (
            "__import__", "import_module"
        ):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path.read_text())) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_walk_sees_the_whole_port_and_catches_imports():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for expected in ("ikflow_tpu_torch/solver.py", "ikflow_tpu_torch/flow/fused_subnet.py", "chip_smoke.py"):
        assert expected in names
    src = "import jax.numpy as jnp\nfrom ikflow_tpu.lm import refine\nimportlib.import_module('jaxlib')\n"
    assert list(_imported_roots(src)) == ["jax", "ikflow_tpu", "jaxlib"]
