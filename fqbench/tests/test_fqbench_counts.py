"""counts/<kernel>.py against hand counts at small shapes: each input
byte read once, each output byte written once, and the integer
operations a symbol or slot."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness, tracing  # noqa: E402


def call(kernel, args, out, kwargs=None):
    return tracing.Call(kernel, 0, tracing.describe(tuple(args)),
                        tracing.describe(kwargs or {}),
                        tracing.describe(out))


def u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8)


def i16(*shape):
    return torch.zeros(shape, dtype=torch.int16)


def i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


# read lengths of 3 slots x 4 lanes: 100 symbols in all
CGRID = torch.tensor([[10, 10, 10, 10], [10, 5, 5, 10], [10, 10, 5, 5]],
                     dtype=torch.int32)
NSYM = 100


def count(kernel, c):
    fn = harness.load_counts(kernel)
    assert fn is not None, kernel
    return fn(c)


def test_quant_pack():
    # (16, 4) int32 counts -> (16, 5) int16 cum + (64,) int32 packed
    c = call("quant_pack", [i32(16, 4)], (i16(16, 5), i32(64)))
    assert count("quant_pack", c) == (256 + 160 + 256, 4 * 64)


def test_frozen_encode_lanes():
    T, L = 10, 4
    c = call("frozen_encode_lanes", [u8(T, L), CGRID, i32(64), None],
             (i16(T, L), u8(T, L), i32(L)))
    assert count("frozen_encode_lanes", c) == (
        40 + 48 + 256 + 80 + 40 + 16, 30 * NSYM)


def test_compact_words():
    emitted = torch.tensor([7], dtype=torch.int32)
    c = call("compact_words", [i16(10, 4), u8(10, 4)], (i16(40), emitted))
    assert count("compact_words", c) == (80 + 40 + 2 * 7 + 4, 2 * 40)


def test_frozen_decode():
    # a padded buffer of 1024 words holds at least 1024 // 2 of them
    c = call("frozen_decode", [i32(4), i16(1024), CGRID, 10, i16(16, 5),
                               None], u8(10, 4))
    assert count("frozen_decode", c) == (
        16 + 48 + 160 + 40 + 2 * 512, 25 * NSYM)


def test_adapt_encode_walk():
    c = call("adapt_encode_walk", [u8(10, 4), CGRID, None, 3], i32(10, 4))
    assert count("adapt_encode_walk", c) == (40 + 48 + 160, 30 * NSYM)


def test_rans_encode_sf():
    c = call("rans_encode_sf", [i32(10, 4), CGRID],
             (i16(10, 4), u8(10, 4), i32(4)))
    assert count("rans_encode_sf", c) == (160 + 48 + 80 + 40 + 16,
                                          20 * NSYM)


def test_adapt_decode():
    c = call("adapt_decode", [i32(4), i16(2048), CGRID, 10, None, 3],
             u8(10, 4))
    assert count("adapt_decode", c) == (16 + 48 + 40 + 2 * 1024,
                                        40 * NSYM)


@pytest.mark.parametrize("side", [None, 24])
def test_unpack_grid(side):
    args = [u8(10, 1), 2] + ([u8(side)] if side else [])
    c = call("unpack_grid", args, u8(10, 4))
    assert count("unpack_grid", c) == (10 + 40 + (side or 0), 3 * 40)


def test_unpack_grid_side_by_keyword():
    c = call("unpack_grid", [u8(10, 1), 15], u8(10, 4), {"side": u8(20)})
    assert count("unpack_grid", c) == (10 + 40 + 20, 3 * 40)


def test_pack_grid():
    c = call("pack_grid", [u8(10, 4), 4], u8(10, 2))
    assert count("pack_grid", c) == (40 + 20, 3 * 40)


@pytest.mark.parametrize("n_exc, kept", [(3, 3), (25, 10)])
def test_pack15(n_exc, kept):
    # cap = T * L // 4 = 10 exceptions kept in the sidecar
    out = (u8(10, 2), u8(16 + 10), torch.tensor([n_exc], dtype=torch.int32))
    c = call("pack15", [u8(10, 4), CGRID], out)
    assert count("pack15", c) == (40 + 48 + 20 + 4 + 16 + kept, 8 * 40)


def test_every_launched_kernel_of_the_cells_has_counts():
    """The kernels that the two cells' jobs launch (the frozen and the
    adaptive coder and the packs) each have a counts file."""
    for k in ("quant_pack", "frozen_encode_lanes", "compact_words",
              "frozen_decode", "adapt_encode_walk", "rans_encode_sf",
              "adapt_decode", "unpack_grid", "pack_grid", "pack15"):
        assert harness.load_counts(k) is not None, k
    assert harness.load_counts("no_such_kernel") is None


def test_large_tensors_are_kept_by_shape_only():
    big = torch.zeros((tracing.SMALL_BYTES + 1,), dtype=torch.uint8)
    info = tracing.describe(big)
    assert info.value is None and info.nbytes == big.numel()
    with pytest.raises(ValueError):
        info.total()
