"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the port: each imported module's top-level name
(the part before the first dot) is compared whole, so ``sshslie_torch`` is
not taken for ``sshslie_tpu``'s kin by its prefix."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_dtypes", "sshslie_tpu"}
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs
                 if f.endswith(".py"))


def top_level_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_walk_sees_every_source():
    assert len(SOURCES) > 20 and os.path.join(BENCH, "run.py") in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert not top_level_imports(path) & {"sshslie_torch", "benchmark"}


def test_the_comparison_is_by_whole_names():
    assert "sshslie_torch" not in FORBIDDEN
    assert top_level_imports(__file__) == {"ast", "os", "pytest"}
