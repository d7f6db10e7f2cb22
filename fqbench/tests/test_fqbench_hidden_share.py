"""driver.serialize_hidden_share: the share of the packing thread's
seconds (pack_s) that the compress call did not wait for (serialize_s),
and nothing where the program keeps no pack_s."""

import os
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness  # noqa: E402

NAME = "driver.serialize_hidden_share"


def _read(compress):
    read = harness.load_cell("se_default.roundtrip").reader(NAME)
    return read(SimpleNamespace(input_mb=96.0, restored_mb=96.0,
                                dbg={"compress": compress, "decompress": {}},
                                phases={}))


@pytest.mark.parametrize("compress, want", [
    ({"serialize_s": 0.5, "pack_s": 4.0}, 87.5),
    ({"serialize_s": 0.0, "pack_s": 2.0}, 100.0),
    ({"serialize_s": 7.2}, None),             # packed on the calling thread
    ({}, None),                               # the adaptive coder
])
def test_hidden_share(compress, want):
    got = _read(compress)
    assert got == (None if want is None else pytest.approx(want))
