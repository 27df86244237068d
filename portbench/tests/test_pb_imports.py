"""No module of the benchmark loads JAX, the JAX package, its bench
script or its benchmarks, and the reference loads nothing of the program:
each import's top-level name (the part before the first dot) compared
whole."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "andvaranaut_tpu", "bench",
             "benchmarks"}


def _top_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.partition(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.partition(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).partition(".")[0]


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_no_jax_nor_jax_package(path):
    assert not FORBIDDEN & set(_top_names(path))


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(_top_names(path))
    assert "andvaranaut_torch" not in names
    # the port's name begins with the JAX package's: compared whole
    assert not {n for n in names if n.startswith("andvaranaut")}


def test_top_level_names_are_compared_whole():
    src = "import andvaranaut_torch.gp\nfrom jaxtyping import x\n"
    tree = ast.parse(src)
    names = {a.name.partition(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.partition(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {"andvaranaut_torch", "jaxtyping"}
    assert not FORBIDDEN & names
