"""frozen.qctx_price_ms_per_MB: the reader of the quality-context
candidates' bz2-9 pricing (the program's train.qctx.price span) on a
synthetic Context, on a table without the span (the parent's, or a file
the adaptive coder takes), and in a traced tiny run of the cells that
list it."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness, tracing  # noqa: E402

from conftest import tiny  # noqa: E402

NAME = "frozen.qctx_price_ms_per_MB"


def context(compress):
    return tracing.Context(4.0, 4.0, {"compress": compress,
                                      "decompress": {}}, {})


@pytest.mark.parametrize("cell", ["se_default.roundtrip",
                                  "pe_default.roundtrip"])
def test_price_reader(cell):
    read = harness.load_cell(cell).reader(NAME)
    assert read(context({"train.qctx_s": 0.8, "train.qctx.price_s": 0.6,
                         "train.qctx.price_n": 17})) == pytest.approx(150.0)


def test_a_table_without_the_span_reads_nothing():
    read = harness.load_cell("se_default.roundtrip").reader(NAME)
    assert read(context({"train_s": 2.0, "train.qctx_s": 0.8})) is None
    assert read(context({})) is None


def test_listed_where_the_trainer_runs():
    listed = {m["name"]: m.get("workloads") for m in
              harness.load_manifest(harness.ROOT)["per_layer"]}
    assert listed[NAME] == ["se_default.roundtrip", "pe_default.roundtrip"]
    assert NAME not in [m["name"] for m in
                        harness.load_cell("se_q3.roundtrip").per_layer]


def test_a_traced_tiny_run_reports_it():
    """se_default cut to 2,000 reads on the CPU: the host scorer prices
    its candidates inside train.qctx.price, which the metric reads."""
    r = harness.run_cell(tiny("se_default.roundtrip"), 2**31 + 3, 0.5, True,
                         "cpu")
    assert r["correct"]
    got = r["metrics"][NAME]
    assert got["unit"] == "ms/MB" and got["value"] > 0
    assert got["value"] <= r["metrics"]["frozen.qctx_ms_per_MB"]["value"]
