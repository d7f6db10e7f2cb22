"""On the card, at each cell's own size: a short run of each cell comes
out correct, and its control (the program's lossy quality path, -l
1.15) comes out not correct.  Run on a machine with a CUDA card:

    python -m pytest fqbench/tests/test_fqbench_gpu.py -m gpu -q
"""

import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness  # noqa: E402

pytestmark = pytest.mark.gpu
CELLS = ("se_default.roundtrip", "se_q3.roundtrip")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(name, seed, *extra):
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", name, "--seed", str(seed), "--seconds", "1",
         "--trace", "0", *extra], capture_output=True, text=True,
        timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(card, name):
    r = _run(name, 2**31 + 101)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["checks"]["bytes_wrong"]["value"] == 0
    assert r["checks"]["archives_unlike"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(card, name):
    r = _run(name, 2**31 + 102, "--control", "lossy")
    assert not r["correct"] and r["checks"]["bytes_wrong"]["value"] > 0
