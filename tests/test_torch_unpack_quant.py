"""K15 unpack_grid (csrc/transfer_pack.cu) and K1 quant_pack
(csrc/quant_pack.cu), their schedules on the CPU.

K15 works in groups of 16 slots, a thread a group: one 4-byte (modes 2
and 23), 8-byte (4 and 15) or three 4-byte (6) load of the packed bytes
where the group lies whole in the grid and the pointers are aligned,
else byte loads of the bytes below the packed end; the codes spread into
bytes by shifts and masks; one 16-byte store, or byte stores below the
grid's end.  The dense modes keep 4 groups a thread, 256 threads apart.
The sentinel modes run one pass: a block takes a tile of 8,192 slots by
atomic ticket (a thread two consecutive groups), marks its sentinels with bit operations on the loaded
word (a nibble with all four bits set, a 2-bit code with both), ranks
them by a block scan, takes the tile's offset by the decoupled look-back
(csrc/lookback.cuh), stages the tile's run of exceptions
side[16 + min(offset + i, len(side) - 17)] and maps each slot: a code
below the sentinel through side[0:16], the k-th sentinel to the k-th
staged byte.

K1 takes one fp32 reciprocal of each row's total and, a symbol, an
estimate of floor(cum * 2^14 / total) from it (the conversions, the
reciprocal and the product toward zero each err by under 2^-22) and one
exact correction from the remainder (32-bit for narrow tables, whose
rows total under 2^30; else 64-bit).  A row goes to a group of G lanes
(1 for at most 8 symbols, else 8, 16 or 32), lane g on k = ceil(A / G)
consecutive counts: the lanes' sums, an inclusive __shfl_up_sync scan
over the group (its last lane's is the total), and each lane's run
quantized from its exclusive prefix.  A block's tile of rows (up to
256, 40 KB) moves through shared memory with 16-byte copies; rows too
wide for that are read and written where they lie.

Plain mirrors of both schedules, kept here and never on the card path,
are held to the JAX package (_unpack{2,4,6,15,23}_dev, _quant_full) and
to the port's plain versions (kernels.unpack_grid_plain,
kernels.quant_pack_plain), which the card tests (tests/test_torch_gpu.py)
hold the kernels to.  Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.ops import kernels as tk
from test_torch_rans_tail import _AGG, _PRE, _look_back

# csrc/transfer_pack.cu
_THREADS, _GROUP, _DENSE_GROUPS, _SENT_GROUPS = 256, 16, 4, 2
_TILE = _THREADS * _SENT_GROUPS * _GROUP
_GROUP_BYTES = {2: 4, 23: 4, 4: 8, 15: 8, 6: 12}
_SENT = {15: 15, 23: 3}
_CODE_BITS = {2: 2, 23: 2, 4: 4, 15: 4, 6: 6}
_JAX_UNPACK = {2: je._unpack2_dev, 4: je._unpack4_dev, 6: je._unpack6_dev}
_U32 = np.uint64(0xFFFFFFFF)


# --- K15: sentinel marks ----------------------------------------------------

def _sent_bits(w, mode):
    """The sentinel marks of a group's packed word (uint64 values): bit
    4k (mode 15) or 2k (mode 23) where slot k holds the sentinel."""
    w = np.asarray(w, np.uint64)
    one = np.uint64(1)
    if mode == 15:
        return (w & (w >> one) & (w >> np.uint64(2)) & (w >> np.uint64(3))
                & np.uint64(0x1111111111111111))
    return w & (w >> one) & np.uint64(0x5555555555555555)


def _codes_of(w, mode, slots):
    bits = _CODE_BITS[mode]
    w = np.asarray(w, np.uint64)
    return np.stack([(w >> np.uint64(bits * k)) & np.uint64((1 << bits) - 1)
                     for k in range(slots)], axis=-1)


def _marks_match(w, mode, slots):
    bits = _CODE_BITS[mode]
    e = _sent_bits(w, mode)
    got = np.stack([(e >> np.uint64(bits * k)) & np.uint64(1)
                    for k in range(slots)], axis=-1) == 1
    want = _codes_of(w, mode, slots) == _SENT[mode]
    assert np.array_equal(got, want)
    # no bit but a slot's lowest is ever set
    low = sum(1 << (bits * k) for k in range(slots))
    assert not (e & ~np.uint64(low)).any()


@pytest.mark.parametrize("mode", [15, 23])
def test_sentinel_marks_equal_a_compare_per_slot(mode):
    """The bit trick == code == sentinel, slot by slot, on every 16-bit
    pattern (4 nibbles, 8 two-bit codes) and on 64-bit (mode 15; 32-bit
    for mode 23's group) words of every class: random, all sentinels,
    none, every code one bit short of the sentinel, a lone sentinel in
    each slot among near misses, and alternating runs."""
    bits = _CODE_BITS[mode]
    _marks_match(np.arange(1 << 16, dtype=np.uint64), mode, 16 // bits)
    width = 64 if mode == 15 else 32
    slots = width // bits
    sent = _SENT[mode]
    rng = np.random.default_rng(mode)
    words = [rng.integers(0, 1 << 62, 4096, dtype=np.uint64) * np.uint64(3)
             & np.uint64((1 << width) - 1)]
    full = sum(sent << (bits * k) for k in range(slots))
    words.append(np.array([full, 0], np.uint64))
    for short in range(bits):                 # one bit short, every slot
        code = sent & ~(1 << short)
        words.append(np.array([sum(code << (bits * k) for k in range(slots))],
                              np.uint64))
        for k in range(slots):                # a lone sentinel among them
            base = sum(code << (bits * j) for j in range(slots) if j != k)
            words.append(np.array([base | (sent << (bits * k))], np.uint64))
    for period in (1, 2, 3):
        words.append(np.array([sum(sent << (bits * k) for k in range(slots)
                                   if (k // period) % 2 == 0)], np.uint64))
    _marks_match(np.concatenate(words), mode, slots)


# --- K15: the groups ---------------------------------------------------------

def _spread2(b):
    return ((b & 3) | ((b & 0xC) << 6) | ((b & 0x30) << 12)
            | ((b & 0xC0) << 18))


def _spread4(h):
    return ((h & 0xF) | ((h & 0xF0) << 4) | ((h & 0xF00) << 8)
            | ((h & 0xF000) << 12))


def _spread6(v):
    return ((v & 63) | ((v >> 6) & 63) << 8 | ((v >> 12) & 63) << 16
            | ((v >> 18) & 63) << 24)


def _load_groups(packed, mode, n, vec):
    """load_group for every group: (G, 3) uint64 words (0 past the group's
    bytes) and whether the group loaded whole (word loads); other groups
    load the bytes below the packed end one at a time."""
    kb = _GROUP_BYTES[mode]
    groups = -(-n // _GROUP)
    whole = vec & ((np.arange(groups) + 1) * _GROUP <= n)
    buf = np.zeros(groups * kb, np.uint8)
    nw = int(whole.sum())                   # whole groups come first
    buf[:nw * kb] = packed[:nw * kb]        # word loads
    idx = (np.flatnonzero(~whole)[:, None] * kb + np.arange(kb)).reshape(-1)
    idx = idx[idx < len(packed)]            # byte loads
    buf[idx] = packed[idx]
    w = np.zeros((groups, 3), np.uint64)
    w[:, :kb // 4] = buf.view("<u4").reshape(groups, kb // 4)
    return w, whole


def _decode_groups(w, mode):
    """decode_group: (G, 16) code bytes."""
    if mode in (2, 23):
        o = [_spread2((w[:, 0] >> np.uint64(8 * j)) & np.uint64(0xFF))
             for j in range(4)]
    elif mode in (4, 15):
        m16 = np.uint64(0xFFFF)
        o = [_spread4(w[:, 0] & m16), _spread4(w[:, 0] >> np.uint64(16)),
             _spread4(w[:, 1] & m16), _spread4(w[:, 1] >> np.uint64(16))]
    else:
        o = [_spread6(w[:, 0]),
             _spread6(((w[:, 0] >> np.uint64(24)) | (w[:, 1] << np.uint64(8)))
                      & _U32),
             _spread6(((w[:, 1] >> np.uint64(16)) | (w[:, 2] << np.uint64(16)))
                      & _U32),
             _spread6(w[:, 2] >> np.uint64(8))]
    o = np.stack(o, axis=1).astype("<u4")
    return o.view(np.uint8).reshape(len(w), 16)


def _store_groups(out, n):
    """store_group: whole groups' 16 bytes, the rest below n."""
    return out.reshape(-1)[:n]


def _k15_dense_mirror(packed, mode, n, vec):
    """unpack_dense over a flat packed buffer: blocks of 4 x 256 groups,
    thread t of block b on groups b * 1024 + t + 256 j; every group once."""
    groups = -(-n // _GROUP)
    per_block = _THREADS * _DENSE_GROUPS
    blocks = -(-n // (per_block * _GROUP))
    q = (np.arange(blocks)[:, None, None] * per_block
         + np.arange(_THREADS)[None, :, None]
         + _THREADS * np.arange(_DENSE_GROUPS)[None, None, :]).reshape(-1)
    q = q[q < groups]
    assert np.array_equal(np.sort(q), np.arange(groups))
    w, _ = _load_groups(packed, mode, n, vec)
    return _store_groups(_decode_groups(w, mode), n)


def _k15_sent_mirror(packed, mode, n, side, vec, rng):
    """unpack_sent over a flat packed buffer: per tile the threads' marks
    and counts, the block's exclusive scan, the tile's count published in
    one order drawn from ``rng`` and the look-backs run in another, the
    staged run of exceptions clipped to the sidecar, and the slots
    mapped."""
    tiles = max(1, -(-n // _TILE))
    per_thread = _SENT_GROUPS * _GROUP
    w, _ = _load_groups(packed, mode, n, vec)
    w = np.concatenate([w, np.zeros((tiles * _THREADS * _SENT_GROUPS
                                     - len(w), 3), np.uint64)])
    word = w[:, 0] | (w[:, 1] << np.uint64(32)) if mode == 15 else w[:, 0]
    e = _sent_bits(word, mode)
    step = 4 if mode == 15 else 2
    marks = ((e[:, None] >> np.uint64(step) * np.arange(16, dtype=np.uint64))
             & np.uint64(1)).astype(bool)                  # (groups, 16)
    # a thread's consecutive groups, its count
    c = marks.reshape(tiles, _THREADS, per_thread).sum(axis=2)
    r = np.cumsum(c, axis=1) - c                           # the block scan
    agg = c.sum(axis=1)
    desc = [0] * tiles
    for t in rng.permutation(tiles):
        a = int(agg[t])
        desc[t] = ((_PRE << 62) | (a << 32) | a) if t == 0 \
            else (_AGG << 62) | (a << 32)
    excl = np.zeros(tiles, np.int64)
    for t in rng.permutation(tiles):
        if t:
            excl[t] = _look_back(desc, t)
            a = int(agg[t])
            desc[t] = (_PRE << 62) | (a << 32) | (int(excl[t]) + a)
    codes = _decode_groups(w, mode).reshape(-1, per_thread)
    out = side[:16][codes]
    # a slot's rank: its thread's scan plus the marks before it in the
    # thread's groups
    m_t = marks.reshape(-1, per_thread)
    rank = r.reshape(-1)[:, None] + np.cumsum(m_t, axis=1) - m_t
    last = len(side) - 17
    for t in range(tiles):
        stage = side[16 + np.minimum(excl[t] + np.arange(agg[t]), last)]
        rows = slice(t * _THREADS, (t + 1) * _THREADS)
        m = m_t[rows]
        out[rows][m] = stage[rank[rows][m]]
    assert excl[-1] + agg[-1] == int((codes.reshape(-1)[:n] == _SENT[mode])
                                     .sum())
    return _store_groups(out, n)


def _grid_and_pack(mode, n, density, rng):
    """A (n / 4, 4) grid and its pack: dense modes random codes; sentinel
    modes the host's pack of a grid whose share ``density`` of slots fall
    outside the top symbols."""
    T = n // 4
    if mode in _JAX_UNPACK:
        g = rng.integers(0, 1 << _CODE_BITS[mode], (T, 4)).astype(np.uint8)
        return g, je._pack_host(g, mode), None
    sent = _SENT[mode]
    top = rng.permutation(48)[:sent if density != "all" else 0]
    rest = np.setdiff1d(np.arange(48), top)
    g = top[rng.integers(0, max(len(top), 1), (T, 4))] if len(top) else \
        rest[rng.integers(0, len(rest), (T, 4))]
    if density == "some":
        hit = rng.random((T, 4)) < 0.1
        g[hit] = rest[rng.integers(0, len(rest), int(hit.sum()))]
    g = g.astype(np.uint8)
    packed, side = je._pack_sent_host(
        g, top.astype(np.uint8), sent,
        je._pack4_host if mode == 15 else je._pack2_host)
    return g, packed, side


# around the group, the 4,096-slot dense block and the 8,192-slot tile
_N = [4096 * 2 - 4, 4096 * 2, 4096 * 2 + 4, 4096 * 37 + 4]


@pytest.mark.parametrize("n", _N)
@pytest.mark.parametrize("mode", [2, 4, 6])
def test_k15_dense_mirror_matches_jax_and_plain(mode, n):
    """unpack_dense's groups (aligned: word loads; unaligned: byte loads)
    == _unpack{2,4,6}_dev and unpack_grid_plain on grids of 4096k - 4,
    4096k and 4096k + 4 slots (a group cut short at the end) and of 37
    tiles + 4."""
    rng = np.random.default_rng(n + mode)
    g, packed, _ = _grid_and_pack(mode, n, None, rng)
    want = np.asarray(_JAX_UNPACK[mode](jnp.asarray(packed)))
    assert np.array_equal(want, g)
    plain = tk.unpack_grid_plain(torch.from_numpy(packed), mode).numpy()
    assert np.array_equal(plain, want)
    for vec in (True, False):
        got = _k15_dense_mirror(packed.reshape(-1), mode, n, vec)
        assert np.array_equal(got, want.reshape(-1))


@pytest.mark.parametrize("n", _N)
@pytest.mark.parametrize("density", ["none", "some", "all"])
@pytest.mark.parametrize("mode", [15, 23])
def test_k15_sent_mirror_matches_jax_and_plain(mode, density, n):
    """unpack_sent's one pass (tile schedules drawn from the seed) ==
    _unpack15_dev / _unpack23_dev and unpack_grid_plain at 8192 - 4,
    8192 and 8192 + 4 slots (a tile and a group either side) and 18.5
    tiles + 4, with no, some (10%) and only sentinels."""
    rng = np.random.default_rng(n * 3 + mode + len(density))
    g, packed, side = _grid_and_pack(mode, n, density, rng)
    fn = je._unpack15_dev if mode == 15 else je._unpack23_dev
    want = np.asarray(fn(jnp.asarray(packed), jnp.asarray(side)))
    assert np.array_equal(want, g)
    plain = tk.unpack_grid_plain(torch.from_numpy(packed), mode,
                                 torch.from_numpy(side)).numpy()
    assert np.array_equal(plain, want)
    for vec in (True, False):
        got = _k15_sent_mirror(packed.reshape(-1), mode, n, side, vec, rng)
        assert np.array_equal(got, want.reshape(-1))


@pytest.mark.parametrize("n_side", [17, 21, 16 + 1000])
@pytest.mark.parametrize("mode", [15, 23])
def test_k15_sent_mirror_clamps_a_short_sidecar(mode, n_side):
    """Random codes (sentinels ~6% / 25%) over 3 tiles + 8 slots against a
    sidecar with 1, 5 and 1,000 exception slots: every sentinel past the
    last slot takes the last byte, as in _unpack{15,23}_dev."""
    rng = np.random.default_rng(n_side + mode)
    n = 3 * _TILE + 8
    packed = rng.integers(0, 256, n * _CODE_BITS[mode] // 8).astype(np.uint8)
    side = rng.integers(0, 64, n_side).astype(np.uint8)
    fn = je._unpack15_dev if mode == 15 else je._unpack23_dev
    p2 = packed.reshape(n // 4, -1)
    want = np.asarray(fn(jnp.asarray(p2), jnp.asarray(side))).reshape(-1)
    plain = tk.unpack_grid_plain(torch.from_numpy(p2), mode,
                                 torch.from_numpy(side)).numpy()
    assert np.array_equal(plain.reshape(-1), want)
    got = _k15_sent_mirror(packed, mode, n, side, True, rng)
    assert np.array_equal(got, want)


# --- K1: the quotient --------------------------------------------------------

_M = 1 << 14


def _rz32(p):
    """float64 values -> float32, rounded toward zero (the product's
    __fmul_rz; a product of two float32 values is exact in float64)."""
    f = p.astype(np.float32)
    return np.where(f.astype(np.float64) > p,
                    np.nextafter(f, np.float32(0)), f)


def _ulps(x, k):
    """x moved by k float32 ulps."""
    x = np.asarray(x, np.float32)
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf if k > 0 else 0))
    return x


def _quant(c, tot, rf):
    """csrc/quant_pack.cu quant: the estimate from the row's reciprocal,
    then the correction by the 64-bit remainder (wrapping, as the card
    computes it)."""
    c = np.asarray(c, np.int64)
    tot = np.asarray(tot, np.int64)
    cf = c.astype(np.float32).astype(np.float64)
    q = _rz32(cf * rf.astype(np.float64)).astype(np.int64)
    rem = ((c.astype(np.uint64) << np.uint64(14))
           - q.astype(np.uint64) * tot.astype(np.uint64)).view(np.int64)
    return q + (rem >= tot) - (rem < 0)


def _quant32(c, tot, rf):
    """quant's 32-bit form (narrow tables, tot < 2^30): the remainder
    modulo 2^32, read as a signed word."""
    c = np.asarray(c, np.int64)
    tot = np.asarray(tot, np.int64)
    assert (tot < 1 << 30).all()
    cf = c.astype(np.float32).astype(np.float64)
    q = _rz32(cf * rf.astype(np.float64)).astype(np.int64)
    rem = (((c << 14) - q * tot) & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32).astype(np.int64)
    return q + (rem >= tot) - (rem < 0)


def _recip14(tot, k=0):
    """recip14: 2^14 / float(tot) in fp32, moved by k ulps (__fdividef
    errs by up to 2 ulps)."""
    tf = np.asarray(tot, np.int64).astype(np.float32)
    return _ulps(np.float32(_M) / tf, k)


def _exact(c, tot):
    tot = np.broadcast_to(tot, np.shape(c))
    return np.array([(int(a) << 14) // int(b) for a, b in
                     zip(np.ravel(c), np.ravel(tot))],
                    np.int64).reshape(np.shape(c))


def test_quant_estimate_is_corrected_to_the_floor():
    """quant == floor(c * 2^14 / tot) for every reciprocal within 3 ulps
    of the IEEE one (its 32-bit form too, below 2^30), on c = 0, 1,
    tot - 1, tot and random c, for totals
    1, powers of two and one below, 2^22, 65,535 x 41, the largest int32
    rows of 256 and 2^18 - 1 counts (tot < 2^49) and random totals; and
    on totals where c * 2^14 / tot lands on or just beside an integer."""
    rng = np.random.default_rng(1)
    tots = [1, 2, 3, 2**22, 2**22 - 1, 65535 * 41, 256 * (2**31 - 1),
            (2**18 - 1) * (2**31 - 1), 2**48, 2**49 - 1]
    tots += [2**k for k in range(1, 49, 3)]
    tots += [2**k - 1 for k in range(2, 49, 3)]
    tots += list(rng.integers(1, 1 << 49, 40))
    for tot in tots:
        c = np.unique(np.concatenate([
            [0, 1, tot - 1, tot, tot // 2, tot // 3, (tot * 2) // 3],
            rng.integers(0, tot + 1, 60)])).astype(np.int64)
        c = c[(c >= 0) & (c <= tot)]
        # c near the multiples of tot / 2^14: quotients on integers
        near = np.array([(int(k) * tot) // _M
                         for k in rng.integers(0, _M + 1, 40)], np.int64)
        c = np.unique(np.concatenate([c, near, near + 1,
                                      np.maximum(near - 1, 0)]))
        c = c[c <= tot]
        want = _exact(c, tot)
        for u in range(-3, 4):
            rf = _recip14(tot, u)
            assert np.array_equal(_quant(c, tot, rf), want)
            if tot < 1 << 30:
                assert np.array_equal(_quant32(c, tot, rf), want)


# --- K1: the groups and tiles ----------------------------------------------

_MAX_ROWS, _TILE_BYTES = 256, 40960
_NP = {"u8": np.uint8, "u16": np.uint16, "i32": np.int32}
_HI = {"u8": 255, "u16": 65535, "i32": 2**31 - 1}


def _k1_layout(A, w):
    """quant_pack.cu launch: (log2 of the lanes G a row, 0 for a thread a
    row (quant_rows_small, A <= 8: tiles of 256 rows), rows a tile or 0
    for rows read where they lie, the tile's runs copied as 16-byte
    words, the 32-bit accumulator)."""
    lg = 0 if A <= 8 else 3 if A <= 32 else 4 if A <= 64 else 5
    rows = min(_MAX_ROWS, (_TILE_BYTES - 32) // (A * (w + 6) + 2))
    rows = rows & ~15 if rows >= 16 else rows & ~7 if rows >= 8 else rows
    # the tile's counts, cum and packed runs and its shared memory
    room = (-(-rows * A * w // 16) * 16 + -(-rows * (A + 1) * 2 // 16) * 16
            + rows * A * 4)
    assert room <= _TILE_BYTES
    vec = rows >= 1 and all(x % 16 == 0 for x in (
        rows * A * w, rows * (A + 1) * 2, rows * A * 4))
    return lg, rows, vec, rows >= 1 and w < 4


def _k1_mirror(counts):
    """quant_rows: tiles of rows (every row taken by one group of G lanes
    of one block); lane g of a row's group sums counts [g k, g k + k), the
    group's inclusive __shfl_up_sync scan gives each lane its prefix and
    the last lane the total; lane g quantizes its run from its exclusive
    prefix, F[g k] from the prefix itself."""
    n, A = counts.shape
    w = counts.dtype.itemsize
    lg, rows, _, narrow = _k1_layout(A, w)
    G = 1 << lg
    per = rows if rows >= 1 else _THREADS >> lg
    taken = sorted(b * per + i0 + (t >> lg)
                   for b in range(-(-n // per))
                   for i0 in range(0, min(per, n - b * per), _THREADS >> lg)
                   for t in range(0, _THREADS, G)
                   if i0 + (t >> lg) < min(per, n - b * per))
    assert taken == list(range(n))
    k = -(-A // G)
    x = np.zeros((n, G * k), np.int64)
    x[:, :A] = counts.astype(np.int64)
    x = x.reshape(n, G, k)
    part = x.sum(axis=2)
    inc = part.copy()
    d = 1
    while d < G:                                  # __shfl_up_sync(.., G)
        y = np.zeros_like(inc)
        y[:, d:] = inc[:, :-d]
        inc = inc + y
        d <<= 1
    tot = np.maximum(inc[:, G - 1], 1)
    q = _quant32 if narrow else _quant
    rf = _recip14(tot)[:, None]
    excl = inc - part
    first = q(excl, tot[:, None], rf)             # F[g k]
    first[:, 0] = 0                               # lane 0: F[0] = 0
    acc = excl[:, :, None] + np.cumsum(x, axis=2)
    F = q(acc, tot[:, None, None], rf[:, :, None])
    prev = np.concatenate([first[:, :, None], F[:, :, :-1]], axis=2)
    F, prev = F.reshape(n, -1)[:, :A], prev.reshape(n, -1)[:, :A]
    cum = np.concatenate([np.zeros((n, 1), np.int64), F], axis=1)
    return cum.astype(np.uint16), (prev | (F << 16)).astype(np.uint32)


def _table(width, A, rng, n=600):
    """Random rows of ``width`` counts, then rows whose totals are 1, a
    power of two, one below a power of two and 2^22 where the width
    reaches them, rows of the largest count, all-zero rows and rows with
    every count on one symbol."""
    hi = _HI[width]
    rows = [rng.integers(0, hi + 1, (n, A), dtype=np.int64),
            rng.integers(0, min(hi, 400) + 1, (n, A), dtype=np.int64),
            np.full((2, A), hi, np.int64), np.zeros((1, A), np.int64)]
    for tot in [1, 2**22] + [2**k for k in (1, 7, 8, 15, 16, 21, 30)] \
            + [2**k - 1 for k in (2, 7, 8, 15, 16, 21, 30)]:
        if tot > A * hi:
            continue
        base, extra = divmod(tot, A)
        r = np.full(A, base, np.int64)
        r[:extra] += 1
        rows.append(r[None])
        rows.append(rng.permutation(r)[None])
        if tot <= hi:
            one = np.zeros(A, np.int64)
            one[rng.integers(0, A)] = tot
            rows.append(one[None])
    return np.concatenate(rows).astype(_NP[width])


@pytest.mark.parametrize("A", [2, 4, 41, 48, 64, 256])
@pytest.mark.parametrize("width", ["u8", "u16", "i32"])
def test_k1_mirror_matches_jax_and_plain(width, A):
    """K1's groups for A (a thread a row up to 8, else 8, 16 or 32 lanes)
    and its tiles == quant_pack_plain on the table as it travels, and ==
    _quant_full on
    the rows within the reference's bound (1 <= total <= 2^22; the plain
    version and K1 take an all-zero row's total as 1)."""
    rng = np.random.default_rng(A * 7 + len(width))
    counts = _table(width, A, rng)
    cum, packed = _k1_mirror(counts)
    t = torch.from_numpy(counts.view(np.int16) if width == "u16" else counts)
    pc, pp = tk.quant_pack_plain(t)
    assert np.array_equal(cum, pc.numpy().view(np.uint16))
    assert np.array_equal(packed.reshape(-1), pp.numpy().view(np.uint32))
    wide = counts.astype(np.int64)
    ok = (wide.sum(axis=1) >= 1) & (wide.sum(axis=1) <= 1 << 22)
    want = np.asarray(je._quant_full(jnp.asarray(wide[ok].astype(np.int32))))
    assert np.array_equal(cum[ok], want.astype(np.uint16))
    if A * _HI[width] > 1 << 22:
        assert ok.sum() < len(ok)       # rows past the reference's bound too


def test_k1_mirror_on_the_largest_int32_rows():
    """Rows of 2^18 - 1 int32 counts of 2^31 - 1 (a total just under 2^49:
    cum * 2^14 just fits the accumulator) and of random large counts, 32
    lanes a row read where it lies: == quant_pack_plain == the exact
    quotient."""
    rng = np.random.default_rng(2)
    A = 2**18 - 1
    counts = np.stack([np.full(A, 2**31 - 1, np.int64),
                       rng.integers(2**30, 2**31, A)]).astype(np.int32)
    cum, packed = _k1_mirror(counts)
    pc, pp = tk.quant_pack_plain(torch.from_numpy(counts))
    assert np.array_equal(cum, pc.numpy().view(np.uint16))
    assert np.array_equal(packed.reshape(-1), pp.numpy().view(np.uint32))
    cs = np.cumsum(counts.astype(np.int64), axis=1)
    pick = rng.integers(0, A, 50)
    for r in range(2):
        assert np.array_equal(cum[r, pick + 1].astype(np.int64),
                              _exact(cs[r, pick], cs[r, -1]))


def test_k1_mirror_on_the_q3_table_shape():
    """A 4,096-row cut of the --qlevel 3 table's shape (41 symbols, u16
    counts up to 65,535; 16 lanes a row, 3 counts a lane) == the plain
    version."""
    rng = np.random.default_rng(3)
    counts = rng.integers(1, 65536, (4096, 41)).astype(np.uint16)
    cum, packed = _k1_mirror(counts)
    pc, pp = tk.quant_pack_plain(torch.from_numpy(counts.view(np.int16)))
    assert np.array_equal(cum, pc.numpy().view(np.uint16))
    assert np.array_equal(packed.reshape(-1), pp.numpy().view(np.uint32))


@pytest.mark.parametrize("A,w,want", [
    (4, 4, (0, 256, True, False)),      # the seq table, i32
    (4, 1, (0, 256, True, True)),       # as u8
    (48, 2, (4, 96, True, True)),       # the fqz qual table, u16
    (41, 2, (4, 112, True, True)),      # the --qlevel 3 table
    (256, 4, (5, 8, True, False)),
    (1000, 1, (5, 5, False, True)),     # byte copies
    (4100, 4, (5, 0, False, False))])   # rows read where they lie
def test_k1_layout_of_the_tables(A, w, want):
    """The launch's lanes a row, rows a tile, 16-byte copies and
    accumulator on the main path's tables and the edges."""
    assert _k1_layout(A, w) == want
