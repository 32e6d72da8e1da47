"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the program either. Top-level module names
are compared whole: ``gmpnp_tpu_torch`` begins with ``gmpnp_tpu`` and is
another package."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "gmpnp_tpu"}


def sources(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")))
def test_reference_stands_alone(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"gmpnp_tpu_torch"})


def test_whole_name_rule():
    """The rule compares whole names: the port passes, the JAX package
    does not."""
    assert "gmpnp_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "gmpnp_tpu.models".split(".")[0] in FORBIDDEN
