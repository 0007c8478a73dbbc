"""Nothing of the benchmark imports JAX or the JAX package, and the references import nothing of
the program (top-level module names compared whole: the program's name begins with the JAX
package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dfc_sa_unet_tpu"}
PROGRAM = "dfc_sa_unet_torch"


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports (absolute imports and importlib strings)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(PORTBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in _imports(path)


def test_the_program_name_is_not_taken_for_the_jax_package():
    """The check compares whole top-level names: the program's name begins with the JAX package's."""
    assert PROGRAM.startswith("dfc_sa_unet_") and PROGRAM not in FORBIDDEN


def test_references_load_without_the_program():
    code = ("import sys; import portbench.reference.dfc_sa_res_block, portbench.reference.transunet_r50_vit_b16;"
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & set({sorted(FORBIDDEN | {PROGRAM})!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_refuses_jax(monkeypatch):
    from portbench import core

    monkeypatch.setitem(sys.modules, "jax", sys.modules[__name__])
    assert core.forbidden_modules() == ["jax"]
