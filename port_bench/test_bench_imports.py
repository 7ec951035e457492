"""No source of the benchmark imports JAX or the JAX package ``repro``, and
the plain reference imports nothing of the program: each import's
top-level module name compared whole (``repro_torch`` is not ``repro``)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
SOURCES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE_MAY = {"__future__", "math", "typing", "torch"}


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_found():
    assert HERE / "run.py" in SOURCES and HERE / "reference" / "model.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_torch_alone(path):
    names = top_names(path)
    assert "repro_torch" not in names and "port_bench" not in names
    assert names <= REFERENCE_MAY, names - REFERENCE_MAY


def test_whole_name_comparison():
    src = "import repro_torch.serving\nfrom repro_torch import fabric\n"
    tmp = ast.parse(src)
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import) else n.module.split(".")[0]
             for n in tmp.body}
    assert names == {"repro_torch"} and not names & FORBIDDEN


def test_run_refuses_the_forbidden_modules():
    import port_bench.run as run

    assert run.forbidden_modules(["repro_torch.serving", "jax.numpy", "repro.models", "os"]) \
        == ["jax", "repro"]
    assert run.forbidden_modules(["repro_torch", "reprox", "flaxen", "jaxtyping"]) == []
