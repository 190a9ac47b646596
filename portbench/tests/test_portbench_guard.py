"""Nothing the benchmark runs imports JAX or the JAX package; the plain
reference imports nothing of the program; a run without a card fails."""
import ast
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests import tiny

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(tiny.PORTBENCH).as_posix()
                                        for p in tiny.PORTBENCH.rglob("*.py")))
def test_no_jax_import(path):
    tops = {m.split(".")[0] for m in _imports(tiny.PORTBENCH / path)}
    assert not tops & BANNED
    if path.startswith("reference/"):
        assert "repro_torch" not in tops and "portbench" not in tops


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_for_test", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax", "repro"]


def test_no_card_no_result():
    """Decided inside the test: on a machine with a card the run would
    measure, so this checks the refusal only where there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, str(tiny.PORTBENCH / "run.py"), "--workload",
                        "olmoe-1b-7b.rag-4k", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tiny.REPO, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_bare_tree_no_result(tmp_path):
    """In a folder holding only BENCHMARK.json and portbench/ the program is
    missing: the run fails and prints no result."""
    import shutil

    shutil.copytree(tiny.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "olmoe-1b-7b.rag-4k",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""
