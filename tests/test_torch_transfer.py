"""The transfer packs of fastqueeze_tpu_torch against fastqueeze_tpu.

A stream's (T, L) symbol grid crosses the host link packed: the encode
and the trainer unpack it on the device (K15 unpack_grid), the decode
packs it there (K16 pack_grid, and K17 pack15 for 6-bit grids).  On the
CPU each wrapper takes its plain version; these tests hold those to the
JAX package's jitted packs on seeded grids of at most 64 x 256 symbols,
the host side (_pack_mode, _pack_for_upload, the host unpacks) to the
JAX package's, K1 to counts0_dev + _quant_full on u8, u16 and i32 count
tables, and the engine's stream round trip through every pack mode.  The
kernels are held to the plain versions on the card by
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.models import base as jb
from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.models import base as tb
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import kernels as tk

T, L = 64, 256


def _skewed(rng, A, shape=(T, L), p_top=0.97, n_top=3):
    """Symbols below A: ``p_top`` of them among the first ``n_top`` of a
    random permutation, the rest uniform."""
    perm = rng.permutation(A)
    g = rng.integers(0, A, shape)
    hot = rng.random(shape) < p_top
    g[hot] = perm[rng.integers(0, n_top, int(hot.sum()))]
    return g.astype(np.uint8)


def _jax_upload(grid, pmode):
    """The JAX package's host pack of ``grid``: (mode, packed, sidecar)."""
    return je._pack_for_upload(grid, pmode)


_UNPACK_CASES = {
    2: (4, 3, 0.5),        # (alphabet, hot symbols, hot share)
    4: (16, 3, 0.5),
    6: (48, 3, 0.5),
    15: (48, 12, 0.995),
    23: (16, 3, 0.99),
}


@pytest.mark.parametrize("mode", sorted(_UNPACK_CASES))
def test_unpack_grid_plain_matches_jax(mode):
    A, n_top, p_top = _UNPACK_CASES[mode]
    grid = _skewed(np.random.default_rng(mode), A, p_top=p_top, n_top=n_top)
    pmode = {2: 2, 4: 4, 6: 6, 15: 6, 23: 4}[mode]
    if mode in (2, 4, 6):
        packed, side = je._pack_host(grid, mode), None
        want = np.asarray(je._unpack_dev(jnp.asarray(packed), mode))
    else:
        got_mode, packed, side = _jax_upload(grid, pmode)
        assert got_mode == mode
        want = np.asarray(je._unpack_dev(jnp.asarray(packed), mode,
                                         jnp.asarray(side)))
    assert np.array_equal(want, grid)
    got = tk.unpack_grid(torch.from_numpy(packed), mode,
                         None if side is None else torch.from_numpy(side))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", [15, 23])
def test_unpack_grid_plain_clamps_a_short_sidecar(mode):
    """More sentinels than the sidecar holds: the reference clips the
    exception index to the last slot (jnp.clip(idx, 0, len(side) - 17))."""
    rng = np.random.default_rng(40 + mode)
    bits = 4 if mode == 15 else 2
    codes = rng.integers(0, 1 << bits, (8, 64)).astype(np.uint8)
    packed = je._pack4_host(codes) if bits == 4 else je._pack2_host(codes)
    side = rng.integers(0, 64, 16 + 5).astype(np.uint8)     # 5 slots
    want = np.asarray(je._unpack_dev(jnp.asarray(packed), mode,
                                     jnp.asarray(side)))
    got = tk.unpack_grid(torch.from_numpy(packed), mode,
                         torch.from_numpy(side))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", [2, 4, 6])
def test_pack_grid_plain_matches_jax(mode):
    grid = np.random.default_rng(7 + mode).integers(
        0, 1 << mode, (T, L)).astype(np.uint8)
    want = np.asarray(je._pack_dev(jnp.asarray(grid), mode))
    got = tk.pack_grid(torch.from_numpy(grid), mode)
    assert got.shape == (T, tk.packed_width(mode, L))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(te._unpack_host(want, mode), grid)


def _ragged_cgrid(rng, T_, L_, full=False):
    """(J, L) read lengths whose lane sums stay within T_ (one short lane
    and one empty lane unless ``full``)."""
    J = 4
    lens = rng.integers(0, T_ // J + 1, (J, L_)).astype(np.int32)
    if full:
        lens[:] = T_ // J
    else:
        lens[:, 3] = 0
    return lens


_PACK15_CASES = {
    "skewed": dict(A=40, p_top=0.99, n_top=12, full=False),
    "ties": dict(A=64, p_top=0.0, n_top=1, full=True),
    "overflow": dict(A=64, p_top=0.1, n_top=3, full=False),
}


@pytest.mark.parametrize("case", sorted(_PACK15_CASES))
def test_pack15_plain_matches_jax(case):
    kw = _PACK15_CASES[case]
    rng = np.random.default_rng(len(case))
    syms = _skewed(rng, kw["A"], p_top=kw["p_top"], n_top=kw["n_top"])
    if case == "ties":
        syms = np.tile(np.arange(64, dtype=np.uint8), T * L // 64).reshape(
            T, L)                               # every count equal
    cg = _ragged_cgrid(rng, T, L, kw["full"])
    valid = np.arange(T)[:, None] < cg.sum(axis=0)[None, :]
    syms = np.where(valid, syms, 0).astype(np.uint8)
    nib_j, side_j, n_j = je._pack15_dev(jnp.asarray(syms),
                                        jnp.asarray(valid))
    nib, side, n_exc = tk.pack15(torch.from_numpy(syms),
                                 torch.from_numpy(cg))
    assert int(n_exc.item()) == int(n_j)
    assert np.array_equal(nib.numpy(), np.asarray(nib_j))
    assert np.array_equal(side.numpy(), np.asarray(side_j))
    cap = syms.size // 4
    assert (int(n_j) > cap) == (case != "skewed")    # flat: past the cap


def _edge_grid(n_exc):
    """64 x 128 6-bit symbols with exactly ``n_exc`` outside the top 15:
    at 1,024 the mode-15 pack (8,192 / 2 + 16 + 1,024 bytes) beats the
    flat 6,144; one more takes the next sidecar bucket (4,096 slots) and
    the grid stays flat."""
    flat = np.zeros(64 * 128, np.uint8)
    flat[:n_exc] = 15 + np.arange(n_exc) % 33      # <= 32 each: not top 15
    flat[n_exc:n_exc + 1400] = 1 + np.arange(1400) % 14      # 100 each
    return flat.reshape(64, 128)


def _upload_grids():
    rng = np.random.default_rng(3)
    return {
        "flat6": (rng.integers(0, 48, (T, L)).astype(np.uint8), 6),
        "skew6_23": (_skewed(rng, 48, p_top=0.995, n_top=3), 6),
        "skew6_15": (_skewed(rng, 48, p_top=0.995, n_top=12), 6),
        "skew4_23": (_skewed(rng, 16, p_top=0.995, n_top=3), 4),
        "mode2": (rng.integers(0, 4, (T, L)).astype(np.uint8), 2),
        "bucket_edge_1024": (_edge_grid(1024), 6),
        "bucket_edge_1025": (_edge_grid(1025), 6),
        "empty": (np.zeros((0, L), np.uint8), 6),
    }


@pytest.mark.parametrize("case", sorted(_upload_grids()))
def test_pack_for_upload_matches_jax(case):
    grid, pmode = _upload_grids()[case]
    jm, jp, js = je._pack_for_upload(grid, pmode)
    tm, tp, ts = te._pack_for_upload(grid, pmode)
    assert tm == jm
    assert np.array_equal(tp, jp)
    if jm in (15, 23):
        assert np.array_equal(ts, js)
    else:
        assert ts is None and np.array_equal(js, je._EXC_NONE)
    if case.startswith("bucket_edge"):
        assert jm == (6 if case.endswith("1025") else 15)


@pytest.mark.parametrize("L_", [4, 6, 8, 257])
def test_pack_mode_matches_jax(L_):
    for cls, kw in (("SeqModel", dict(alphabet=4, init=3, inc=1, cap=253,
                                      order=4)),
                    ("QualModel", dict(alphabet=16)),
                    ("QualModel", dict(alphabet=48)),
                    ("QualModel", dict(alphabet=64)),
                    ("CtxModel", dict(alphabet=65, n_ctx=1))):
        jm, tm = getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)
        assert te._pack_mode(tm, L_) == je._pack_mode(jm, L_), (cls, kw)


@pytest.mark.parametrize("mode", [2, 6])
def test_host_unpack_matches_jax(mode):
    grid = np.random.default_rng(mode).integers(0, 1 << mode,
                                                (T, L)).astype(np.uint8)
    packed = te._pack_host(grid, mode)
    assert np.array_equal(packed, je._pack_host(grid, mode))
    assert np.array_equal(te._unpack_host(packed, mode),
                          je._unpack_host(packed, mode))


@pytest.mark.parametrize("dtype", ["u8", "u16", "i32"])
def test_quant_pack_reads_each_table_type(dtype):
    """K1 on the table as it travels (u8, u16 in int16 bits, or i32) ==
    counts0_dev (the reference's device widening) + _quant_full."""
    rng = np.random.default_rng(len(dtype))
    hi, np_t = {"u8": (256, np.uint8), "u16": (65536, np.uint16),
                "i32": (1 << 20, np.int32)}[dtype]
    counts = rng.integers(1, hi, (256, 12)).astype(np_t)
    want = np.asarray(je._quant_full(je.counts0_dev(counts)))
    t = torch.from_numpy(counts.view(np.int16) if np_t == np.uint16
                         else counts)
    cum, packed = tk.quant_pack(t)
    assert np.array_equal(cum.numpy().view(np.uint16), want)
    P = packed.numpy().view(np.uint32).reshape(256, 12).astype(np.int64)
    assert np.array_equal(P, want[:, :-1] | (want[:, 1:] << 16))
    table = te.frozen_table(counts, "cpu")      # the narrow upload
    assert torch.equal(table.cum, cum) and torch.equal(table.packed, packed)


_STREAMS = {       # (model, symbols): the pack the engine picks
    "seq_mode2": ("SeqModel", dict(alphabet=4, init=3, inc=1, cap=253,
                                   order=4), 4, 0.0),
    "qual_mode6": ("QualModel", dict(alphabet=48), 48, 0.0),
    "qual_mode15": ("QualModel", dict(alphabet=48), 48, 0.995),
    "qual_mode4": ("QualModel", dict(alphabet=16), 16, 0.0),
}


@pytest.mark.parametrize("name", sorted(_STREAMS))
def test_frozen_stream_round_trip_through_the_packs(name):
    """encode_stream / decode_stream (frozen, device="cpu") through K15,
    K16 and K17's plain versions: the JAX package's payload, and the
    decode gives the symbols back (K17's sentinel fetch on skewed 6-bit
    qualities, the plain pack on flat ones)."""
    cls, kw, A, p_top = _STREAMS[name]
    jm, tm = getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)
    rng = np.random.default_rng(len(name))
    counts = rng.integers(20, 60, 300).astype(np.int64)
    syms = _skewed(rng, A, shape=(int(counts.sum()),), p_top=p_top,
                   n_top=2)
    table = rng.integers(1, 250, (tm.n_ctx, A)).astype(np.uint8)
    jkw = dict(lanes_min=8, lanes_max=64, lane_target_symbols=256)
    want = je.encode_stream(jm, JParams(**jkw), syms, counts,
                            counts0=jnp.asarray(table.astype(np.int32)),
                            adapt=False)
    tk.reset_launch_counts()
    got = te.encode_stream(tm, CodecParams(**jkw), syms, counts,
                           counts0=table, device="cpu")
    assert got == want
    back = te.decode_stream(tm, CodecParams(**jkw), got, counts,
                            counts0=table, device="cpu")
    assert np.array_equal(back, syms)


@pytest.mark.parametrize("shape", [(0, 64), (7, 128), (T, L)])
def test_sentinel_fetch_matches_jax_reconstruct(shape):
    """The decode's host side of K17's pack (nibbles + [perm | the
    exceptions]) == the reference's DecodeJob._fetch_sentinel rebuild."""
    rng = np.random.default_rng(shape[0])
    codes = rng.integers(0, 16, shape).astype(np.uint8)
    nib = je._pack4_host(codes)
    side = rng.integers(0, 64, 16 + int((codes == 15).sum())).astype(np.uint8)
    perm, exc = side[:16], side[16:]
    flat = je._unpack4_host(nib).reshape(-1)
    mask = flat == je._EXC_SYM
    want = perm[np.minimum(flat, je._EXC_SYM)]
    want[mask] = exc[np.cumsum(mask)[mask] - 1]
    assert np.array_equal(te._unsent_host(nib, side), want.reshape(shape))
    assert np.array_equal(te._unpack4_host(nib), je._unpack4_host(nib))
