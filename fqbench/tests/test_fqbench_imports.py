"""Nothing under fqbench/ imports JAX or the JAX package: its sources
name neither, and a run leaves none of them in sys.modules (top-level
names compared whole: the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "fastqueeze_tpu"}


def _sources():
    for d, _, files in os.walk(harness.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_top_imports(path)) & FORBIDDEN


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastqueeze_tpu_torch_x", sys)
    assert "fastqueeze_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fastqueeze_tpu.sub", sys)
    assert harness.forbidden_modules() == ["fastqueeze_tpu"]


def test_a_run_loads_none_of_them():
    """A tiny CPU run of each cell in a fresh process, then sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import tiny\n"
        "from fqbench import harness\n"
        "for n in ('se_default.roundtrip', 'se_q3.roundtrip'):\n"
        "    r = harness.run_cell(tiny(n), 3, 0.5, False, 'cpu')\n"
        "    assert r['correct'], r\n"
        "print('LOADED', harness.forbidden_modules())\n"
        % (harness.ROOT, os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def test_the_command_fails_without_a_card():
    """run.py never falls back to the CPU: with no CUDA card it exits
    non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", "se_q3.roundtrip", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
