"""Nothing the benchmark runs imports JAX or the JAX package, its
reference imports nothing of the program, and without a card it refuses
to run."""

import ast
import os
import subprocess
import sys

from benchmark.tests import tiny

JAX_NAMES = {"jax", "jaxlib", "flax", "mcqueens"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(tiny.BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        bad = set(_imports(path)) & JAX_NAMES
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((tiny.BENCH / "reference").rglob("*.py")):
        names = set(_imports(path))
        assert "mcqueens_torch" not in names, path
        assert names <= {"__future__", "numpy", "torch", "itertools",
                         "benchmark"}, (path, names)


def test_no_card_exits_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "board_n16.anneal", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=tiny.REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_are_named(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "mcqueens.core", object())
    assert run.guard() == ["jax", "mcqueens"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.delitem(sys.modules, "mcqueens.core")
    monkeypatch.setitem(sys.modules, "mcqueens_torch_x", object())
    assert run.guard() == []
