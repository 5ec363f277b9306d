"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: iamf_tpu_torch is not iamf_tpu), and the reference
imports nothing of the program."""

import ast
import glob
import os

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "iamf_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return sorted(glob.glob(os.path.join(BENCH, sub, "**", "*.py"),
                            recursive=True))


def test_no_jax_anywhere():
    files = _sources()
    assert len(files) > 20
    for path in files:
        bad = FORBIDDEN & set(_imports(path))
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    files = _sources("reference")
    assert files
    for path in files:
        assert "iamf_tpu_torch" not in set(_imports(path)), path
        assert "harness" not in set(_imports(path)), path
