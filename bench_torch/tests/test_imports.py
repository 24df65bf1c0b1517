"""Nothing under bench_torch/ imports jax, the JAX package or bench.py, and
the reference imports nothing of the program."""

import ast
import glob
import os

from harness import manifest

FORBIDDEN = {"jax", "jaxlib", "rust_renderer_tpu", "bench"}


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_no_module_imports_jax_or_the_jax_package_or_bench_py():
    files = glob.glob(os.path.join(manifest.BENCH_DIR, "**", "*.py"), recursive=True)
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(manifest.BENCH_DIR, "rrt_reference", "**", "*.py"),
                      recursive=True)
    for path in files:
        for name in _imports(path):
            assert not name.startswith("rust_renderer_tpu"), (path, name)
