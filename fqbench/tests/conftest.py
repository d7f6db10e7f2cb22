"""Shared helpers of the benchmark's tests: a cell of the manifest cut to
a size that the CPU runs in seconds (the kernels' plain versions)."""

import copy
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness  # noqa: E402

# 2,000 reads over a 1 Mbp genome in blocks of 100 kB; the frozen path
# forced on, since the usemodel gate counts 50 MB blocks
TINY = {"se_default.roundtrip": {"use_model": 1, "block_bytes": 100_000},
        "se_q3.roundtrip": {"block_bytes": 100_000}}


def tiny(name: str, root: str = harness.ROOT,
         bench_dir: str = harness.BENCH_DIR) -> harness.Cell:
    cell = harness.load_cell(name, root, bench_dir)
    cell.config = copy.deepcopy(cell.config)
    cell.config["params"].update(TINY.get(name, {}))
    cell.config["reads"]["genome_bp"] = 1_000_000
    cell.mix = dict(cell.mix, reads_per_file=2_000)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
