"""Nothing under portbench/ imports JAX, Flax or the JAX package, and the
reference imports nothing of the program under test: each imported
module's top-level name (the part before the first dot) is compared
whole, so the port (``repro_torch``) is not taken for the JAX package
(``repro``)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BANNED = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(HERE.rglob("*.py"))


def imported(path: Path):
    """Top-level names of the modules a file imports (relative imports as
    ``portbench`` and the subpackage they name)."""
    rel = path.relative_to(HERE.parent).with_suffix("").parts
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = rel[:len(rel) - node.level]
                mod = ".".join(base + ((node.module,) if node.module else ()))
                out |= {f"{mod}.{a.name}" for a in node.names}
            else:
                out.add(node.module)
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & BANNED, f"{path} imports {tops & BANNED}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for mod in imported(path):
        top = mod.split(".")[0]
        assert top != "repro_torch", f"{path} imports {mod}"
        if top == "portbench":
            assert mod.startswith("portbench.reference"), \
                f"{path} imports {mod}"


def test_reference_loads_no_program_module():
    code = ("import sys; import portbench.reference.model, "
            "portbench.reference.vet; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=HERE.parent, timeout=120, check=True)
    tops = set(eval(out.stdout))
    assert not tops & (BANNED | {"repro_torch"})
