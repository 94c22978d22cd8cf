"""Nothing under vio_bench/ imports JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "rd_vio_tpu"}


def imported(path: Path):
    """The full name of every module the file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            yield node.args[0].value


def imported_tops(path: Path):
    return {name.split(".")[0] for name in imported(path)}


def test_top_level_comparison_is_whole_names():
    assert "rd_vio_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "rd_vio_tpu.models".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not (set(imported_tops(path)) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "rd_vio_tpu_torch" not in tops
    assert tops <= {"__future__", "typing", "torch", "numpy", "math", "vio_bench"}
    assert all(name.startswith("vio_bench.reference") for name in imported(path)
               if name.split(".")[0] == "vio_bench")
