"""The tail of every device encode, K7 rans_encode_sf (csrc/rans_encode.cu,
the reverse chain fqk::rans_encode_lane in csrc/lane_walk.cuh that K2 runs
too) and K3 compact_words (csrc/compact_words.cu), on the CPU.

K7 runs one thread a lane, the 32 lanes of a warp in lockstep from the
top wave any of them fills: waves above it are zeroed by a loop of their
own, and a lane shorter than the warp's longest steps on the identity
slot (start 0, freq 2^14), which keeps x at 2^16 (word 0) and never
emits.  Slots are staged in a ring of 3 stages of 24 waves, two stages
ahead (waves below 0 zero-filled), and each stage is loaded into
registers, the identity slot past the lane's end, with each divisor's
reciprocal (recip32, from a table of d = 0 .. 2^14 the launch fills)
while the chain runs the stage before, so no division is on the chain;
a stage's words and flags are stored while the chain runs the next.  A step tests the emit against f << 18 (f =
2^14 never emits), then takes x' = x + start + (q + 1) (M - d) with q the
high half of x * recip, less M - d where the sign of x - (q + 1) d says q
was exact.

K3 runs one launch: a block takes a tile of 4096 slots by atomic ticket,
each of its 256 threads counts the nonzero bytes of its 16 flags (bit
tricks and a popcount a 32-bit word), a block scan ranks the emitted
words in the tile, the tile publishes its count and takes its offset by
a decoupled look-back over the tiles' descriptors (csrc/lookback.cuh,
K17's too), and stores its words at out[offset + rank]; the last tile
writes the count.

Plain mirrors of both schedules, kept here and never on the card path,
are held to the JAX engine (_pass2: emit flags, emitted words, final
states; _compact_words: the dense prefix and the count) and to the port's
plain versions (kernels.rans_encode_sf_plain, kernels.compact_words_plain),
which the card tests (tests/test_torch_gpu.py) hold the kernels to.
Inputs come from numpy with a seed: the sf grids of the adaptive and the
semi-adaptive walks' plain versions on seq and quality streams (40 lanes:
a warp and a part), and grids of freq 0, 1 and 2^14 with lanes of length
0 and T and T not a multiple of 24; for K3 sizes around the tile and
flag densities from none to all, the look-back run under tile schedules
drawn from the seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import kernels as tk
from test_torch_semi_cluster import _stream

_M = 1 << 14
_U32 = np.uint64(0xFFFFFFFF)
# csrc/lane_walk.cuh: the reverse chain's ring and identity slot
_WAVES, _STAGES, _WARP = 24, 3, 32
_IDENT = _M << 16
# csrc/compact_words.cu and csrc/lookback.cuh
_THREADS, _PER, _WINDOW = 256, 16, 32
_TILE = _THREADS * _PER
_AGG, _PRE = 1, 2


# --- K7: the reverse step ---------------------------------------------------

def _recip32(d):
    """lane_walk.cuh recip32: floor(2^32 / d), 2^32 - 1 for d = 1."""
    d = np.asarray(d, np.uint64)
    q = _U32 // d
    return np.where(d == 1, q, q + ((_U32 - q * d) == d - np.uint64(1)))


# rans_encode.cu fill_recip: recip32(max(d, 1)) for d = 0 .. 2^14
_RECIP = _recip32(np.maximum(np.arange(_M + 1, dtype=np.uint64), 1))


def _rev_slot(w):
    """rev_slot: the sf word and the reciprocal of its divisor max(f, 1),
    K7's from the table at min(f, 2^14)."""
    w = np.asarray(w, np.uint64)
    f = ((w >> np.uint64(16)) - (w & np.uint64(0xFFFF))) & _U32
    return w, _RECIP[np.minimum(f, np.uint64(_M)).astype(np.int64)]


def _rev_step(x, w, rcp):
    """rev_step on uint64 arrays holding u32 values: (x', emit)."""
    x, w, rcp = (np.asarray(a, np.uint64) for a in (x, w, rcp))
    start = w & np.uint64(0xFFFF)
    f = ((w >> np.uint64(16)) - start) & _U32
    d = np.where(f == 0, np.uint64(1), f)
    md = (np.uint64(_M) - d) & _U32
    e = (x >= ((f << np.uint64(18)) & _U32)) & (f < np.uint64(_M))
    x1 = np.where(e, x >> np.uint64(16), x)
    q = (x1 * rcp) >> np.uint64(32)
    sign = (((x1 - d - q * d) & _U32) >> np.uint64(31)).astype(bool)
    xb = (x1 + start + md + q * md) & _U32
    return np.where(sign, (xb - md) & _U32, xb), e


def _pass2_step(x, start, f):
    """_pass2's body on one valid slot, in numpy."""
    x, start, f = (np.asarray(a, np.uint64) for a in (x, start, f))
    e = (x >> np.uint64(18)) >= f
    x1 = np.where(e, x >> np.uint64(16), x)
    fs = np.maximum(f, np.uint64(1))
    q = x1 // fs
    return ((q << np.uint64(14)) + (x1 - q * fs) + start) & _U32, e


def test_rev_step_is_pass2s_step():
    """rev_step == _pass2's step for every freq 0 .. 2^14 (start 0 and the
    largest start it allows) at x = 2^16 (the initial state), the emit
    edges (f << 18) - 1 and f << 18, their quotient edges, 2^32 - 1, and
    at 10^5 seeded (x, start, freq) triples; and the identity slot keeps
    every x and never emits."""
    f = np.arange(_M + 1, dtype=np.uint64)
    edge = (f << np.uint64(18)) & _U32
    xs = [np.full_like(f, 1 << 16), edge - np.uint64(1), edge,
          edge + np.uint64(1), (edge >> np.uint64(16)) * f,
          np.full_like(f, 0xFFFFFFFF), np.full_like(f, 0xFFFFFFFE)]
    for start in (np.zeros_like(f), np.uint64(_M) - f):
        w = start | ((start + f) << np.uint64(16))
        for x in xs:
            x = x & _U32
            got = _rev_step(x, *_rev_slot(w))
            want = _pass2_step(x, start, f)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
    rng = np.random.default_rng(14)
    x = rng.integers(0, 1 << 32, 100_000, dtype=np.uint64)
    ff = rng.integers(0, _M + 1, 100_000).astype(np.uint64)
    st = (rng.random(100_000) * (_M - ff + 1)).astype(np.uint64)
    w = st | ((st + ff) << np.uint64(16))
    got = _rev_step(x, *_rev_slot(w))
    want = _pass2_step(x, st, ff)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                               want[1])
    xn, e = _rev_step(x, *_rev_slot(np.full_like(x, _IDENT)))
    assert np.array_equal(xn, x) and not e.any()
    assert int(_rev_slot(_IDENT)[1]) == 1 << 18


# --- K7: the lane schedule --------------------------------------------------

def _k7_mirror(sf, n):
    """rans_encode_lane over a (T, L) sf grid (u32 values) and the lanes'
    lengths, a warp of 32 lanes at a time: the waves from the warp's top
    zeroed, then its stages staged into the ring two ahead, each loaded
    with its reciprocals while the chain runs the stage before, the
    remainder stage last; a full stage's words and flags stored while the
    chain runs the next (zeros where stage 0's go first), the remainder's
    as they come.  Returns (words, emit, final states)."""
    T, L = sf.shape
    n = np.minimum(n, T)
    words = np.full((T, L), -1, np.int64)
    emit = np.full((T, L), -1, np.int64)
    states = np.zeros(L, np.uint64)
    for w0 in range(0, L, _WARP):
        cols = np.arange(w0, min(w0 + _WARP, L))
        nl = n[cols]
        top = int(nl.max())
        words[top:, cols] = 0
        emit[top:, cols] = 0
        full, rem = divmod(top, _WAVES)
        nst = full + (rem > 0)
        ring = [None] * _STAGES               # (stage, slots)

        def stage(k):
            if k < nst:
                slots = np.zeros((_WAVES, len(cols)), np.int64)
                for i in range(_WAVES):
                    t = top - 1 - k * _WAVES - i
                    if t >= 0:                # below 0: zero-filled
                        slots[i] = sf[t, cols]
                ring[k % _STAGES] = (k, slots)

        def load(k):
            tag, slots = ring[k % _STAGES] or (None, None)
            if k >= nst:                      # past the last stage: unused
                return None
            assert tag == k                   # not overwritten before use
            t = top - 1 - k * _WAVES - np.arange(_WAVES)
            return [_rev_slot(np.where(t[i] < nl, s, _IDENT))
                    for i, s in enumerate(slots)]

        def chain(cur, waves, x, t):
            out = []                          # (row, word, flag) a step
            for i in range(waves):
                assert t >= 0
                w = (x & np.uint64(0xFFFF)).astype(np.int64)
                x, e = _rev_step(x, *cur[i])
                out.append((t, w, e))
                t -= 1
            return x, t, out

        def store(out):
            for t, w, e in out:
                words[t, cols] = w
                emit[t, cols] = e

        stage(0)
        stage(1)
        cur = load(0)
        x = np.full(len(cols), 1 << 16, np.uint64)
        t = top - 1
        held = [(top - 1 - i, 0, 0) for i in range(_WAVES)]
        for k in range(full):
            stage(k + 2)
            nxt = load(k + 1)
            store(held)                       # zeros at k = 0
            x, t, held = chain(cur, _WAVES, x, t)
            cur = nxt
        if full:
            store(held)
        x, t, out = chain(cur, rem, x, t)
        store(out)
        assert t == -1
        states[cols] = x
    assert (words >= 0).all() and (emit >= 0).all()
    return words, emit.astype(bool), states


def _lens(cg):
    return np.asarray(cg, np.int64).sum(axis=0)


def _check_k7(sf, cg):
    """The mirror == _pass2 (emit flags, emitted words, final states) and
    == rans_encode_sf_plain (words with 0 at padding, emit, states)."""
    sf = np.asarray(sf, np.int64) & 0xFFFFFFFF
    T, L = sf.shape
    n = _lens(cg)
    words, emit, x = _k7_mirror(sf, n)
    valid = np.arange(T)[:, None] < n[None, :]
    start = np.where(valid, sf & 0xFFFF, 0)
    freq = np.where(valid, (sf >> 16) - (sf & 0xFFFF), 1)
    jw, jemit, jx = je._pass2(jnp.asarray(start, jnp.uint16),
                              jnp.asarray(freq, jnp.uint16),
                              jnp.asarray(valid))
    jemit = np.asarray(jemit)
    assert np.array_equal(emit, jemit)
    assert np.array_equal(words[jemit], np.asarray(jw)[jemit])
    assert np.array_equal(x, np.asarray(jx).astype(np.uint64))
    pw, pe, px = tk.rans_encode_sf_plain(
        torch.from_numpy(sf.astype(np.uint32).view(np.int32)),
        torch.from_numpy(np.asarray(cg, np.int32)))
    assert np.array_equal(words, pw.numpy().view(np.uint16))
    assert np.array_equal(emit, pe.numpy().astype(bool))
    assert np.array_equal(x, px.numpy().view(np.uint32))
    return emit


def _walk_sf(name, walk):
    """sf of a stream from the adaptive walk's or the semi-adaptive walk's
    (chunk 16) plain version."""
    _, tm, g, cg, _, _, _ = _stream(name)
    gt, ct = torch.from_numpy(g), torch.from_numpy(cg)
    L = g.shape[1]
    if walk == "adapt":
        sf = tk.adapt_encode_walk_plain(gt, ct, tm, te._n_halve(tm, L))
    else:
        sf, _ = tk.semi_encode_walk_plain(gt, ct, tm,
                                          te._n_halve_chunk(tm, L, 16), 16)
    return sf.numpy(), cg


@pytest.mark.parametrize("walk", ["adapt", "semi"])
@pytest.mark.parametrize("name", ["seq_o6", "fqz_q2"])
def test_k7_mirror_on_walk_sf_matches_jax_pass2_and_plain(name, walk):
    """K7's schedule over the sf grid K5's or K11's plain version writes
    (40 lanes: one warp and 8 lanes of the next; zero-length reads, lanes
    of different lengths) == _pass2 and the plain version."""
    sf, cg = _walk_sf(name, walk)
    assert sf.shape[1] == 40
    emit = _check_k7(sf, cg)
    assert emit.any() and not emit.all()


def _edge_grid(kind, T, L, seed):
    """A (T, L) sf grid of valid words and one read a lane: ``kind``
    "freq1" (f = 1 at 60% of slots), "freq16384" (f = 2^14, start 0, at
    60%), "freq0" (zero-frequency symbols at 20%) or "mixed"; lane
    lengths 0, T, T - 1, 1, 23, 24, 25 and random."""
    rng = np.random.default_rng(seed)
    f = rng.integers(1, 300, (T, L))
    if kind == "freq1":
        f[rng.random((T, L)) < 0.6] = 1
    elif kind == "freq16384":
        f[rng.random((T, L)) < 0.6] = _M
    elif kind == "freq0":
        f[rng.random((T, L)) < 0.2] = 0
    else:
        pick = rng.random((T, L))
        f[pick < 0.2] = 1
        f[(pick >= 0.2) & (pick < 0.3)] = _M
        f[(pick >= 0.3) & (pick < 0.35)] = 0
        f[pick > 0.9] = rng.integers(8000, _M, int((pick > 0.9).sum()))
    start = (rng.random((T, L)) * (_M - f + 1)).astype(np.int64)
    sf = start | ((start + f) << 16)
    n = rng.integers(0, T + 1, L)
    n[:7] = [0, T, T - 1, 1, 23, 24, 25]
    n[-3:] = [T, 0, T]                # the last warp's lanes: full and empty
    n = np.minimum(n, T)
    sf[np.arange(T)[:, None] >= n[None, :]] = 0
    return sf, n[None, :].astype(np.int32)


@pytest.mark.parametrize("T", [1, 23, 24, 25, 49, 100])
@pytest.mark.parametrize("kind", ["freq1", "freq16384", "freq0", "mixed"])
def test_k7_mirror_on_edge_grids_matches_jax_pass2_and_plain(kind, T):
    """K7's schedule over grids of freq 1, 2^14 and 0 (emit-heavy,
    identity and zero-frequency steps), lanes of length 0 and T, 37 lanes
    (a warp and a part of one), T below, at and around 24 and its
    multiples == _pass2 and the plain version."""
    sf, cg = _edge_grid(kind, T, 37, seed=T)
    _check_k7(sf, cg)


def test_k7_mirror_with_no_waves():
    """T = 0: nothing written, every state the initial 2^16."""
    sf = np.zeros((0, 5), np.int64)
    words, emit, x = _k7_mirror(sf, np.zeros(5, np.int64))
    assert words.shape == (0, 5) and (x == 1 << 16).all()
    _, _, px = tk.rans_encode_sf_plain(torch.zeros((0, 5), dtype=torch.int32),
                                       torch.zeros((1, 5), dtype=torch.int32))
    assert (px.numpy() == 1 << 16).all()


# --- K3 -----------------------------------------------------------------

def _nonzero_bytes(v):
    """compact_words.cu nonzero_bytes on uint32 values (as uint64)."""
    v = np.asarray(v, np.uint64)
    return (((v & np.uint64(0x7F7F7F7F)) + np.uint64(0x7F7F7F7F)) | v) \
        & np.uint64(0x80808080)


def test_nonzero_bytes_marks_every_nonzero_byte():
    """nonzero_bytes sets bit 7 of a byte exactly where the byte is
    nonzero, for every byte value in every position beside every value
    of its neighbours' extremes."""
    b = np.arange(256, dtype=np.uint64)
    for pos in range(4):
        for other in (0x00, 0x01, 0x7F, 0x80, 0xFF):
            rest = np.uint64(sum(other << (8 * p) for p in range(4)
                                 if p != pos))
            v = (b << np.uint64(8 * pos)) | rest
            m = _nonzero_bytes(v)
            for p in range(4):
                byte = (v >> np.uint64(8 * p)) & np.uint64(0xFF)
                bit = (m >> np.uint64(8 * p + 7)) & np.uint64(1)
                assert np.array_equal(bit == 1, byte != 0)
            assert not (m & np.uint64(0x7F7F7F7F)).any()


def _desc_value(d, kind):
    return (d >> 32) & 0x3FFFFFFF if kind == "count" else d & 0xFFFFFFFF


def _look_back(desc, tile):
    """lookback.cuh look_back, its 32 lanes at once: every tile before
    ``tile`` published (the kernel's lanes wait on the rest)."""
    excl = 0
    base = tile - 1
    while True:
        lanes = []
        for lane in range(_WINDOW):
            j = base - lane
            d = (_PRE << 62) if j < 0 else desc[j]
            assert d >> 62                    # published
            lanes.append(d)
        pre = [lane for lane, d in enumerate(lanes) if d >> 62 == _PRE]
        stop = pre[0] if pre else _WINDOW
        excl += sum(_desc_value(d, "count") for d in lanes[:stop])
        if pre:
            return excl + _desc_value(lanes[stop], "prefix")
        base -= _WINDOW


def _k3_mirror(words, emit, rng):
    """compact_words.cu over flat u16 words and u8 flags: per tile the
    threads' nonzero-flag counts (four 32-bit words of flags each), the
    block's exclusive scan, the words staged in scan order; the tiles'
    counts published in one order drawn from ``rng`` and their
    look-backs run in another (tiles 0.. take their tickets in order; a
    look-back sees the prefixes published so far); then the stores and
    the count from the last tile."""
    n = len(words)
    tiles = max(1, -(-n // _TILE))
    e = np.zeros(tiles * _TILE, np.uint8)
    e[:n] = emit
    w = np.zeros(tiles * _TILE, np.uint16)
    w[:n] = words
    m = _nonzero_bytes(e.view("<u4").astype(np.uint64)).reshape(
        tiles, _THREADS, _PER // 4)
    c = np.vectorize(lambda v: bin(int(v)).count("1"))(m).sum(axis=2)
    r = np.cumsum(c, axis=1) - c                   # the block scan
    agg = c.sum(axis=1)
    # a slot's flag: bit 7 of its byte in its thread's mask words
    keep = ((m[..., None] >> (8 * np.arange(4) + 7).astype(np.uint64))
            & np.uint64(1)).reshape(tiles, _TILE).astype(bool)
    stage = []
    for t in range(tiles):
        tw = w[t * _TILE:(t + 1) * _TILE].reshape(_THREADS, _PER)
        tk_ = keep[t].reshape(_THREADS, _PER)
        s = np.zeros(agg[t], np.uint16)
        for th in range(_THREADS):
            got = tw[th][tk_[th]]
            s[r[t, th]:r[t, th] + len(got)] = got
        stage.append(s)
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
    out = np.zeros(n, np.uint16)
    for t in range(tiles):
        out[excl[t]:excl[t] + agg[t]] = stage[t]
    return out, int(excl[-1] + agg[-1])


def _flags(case, n, rng):
    if case == "none":
        return np.zeros(n, np.uint8)
    if case == "all":
        return np.ones(n, np.uint8)
    if case == "any_byte":           # nonzero bytes other than 1 count too
        e = rng.integers(0, 256, n).astype(np.uint8)
        e[rng.random(n) < 0.5] = 0
        return e
    p = {"sparse": 0.02, "half": 0.5, "dense": 0.97}[case]
    return (rng.random(n) < p).astype(np.uint8)


_SIZES = [0, 1, 100, _TILE - 1, _TILE, _TILE + 1, 3 * _TILE - 1,
          3 * _TILE + 1, 40 * _TILE + 123]


@pytest.mark.parametrize("n", _SIZES)
@pytest.mark.parametrize("case", ["none", "all", "sparse", "half", "dense",
                                  "any_byte"])
def test_k3_mirror_matches_jax_compact_words_and_plain(case, n):
    """K3's one pass (tile schedules drawn from the seed) == _compact_words
    (the dense prefix and the count) and == compact_words_plain (the whole
    output, zeros past the count) at n = 0, below a tile, tile multiples
    and +- 1, and 40 tiles + 123 (the look-back steps over windows of 32
    tiles), flags from none to all."""
    rng = np.random.default_rng(n * 7 + len(case))
    words = rng.integers(0, 1 << 16, n).astype(np.uint16)
    emit = _flags(case, n, rng)
    out, count = _k3_mirror(words, emit, rng)
    assert count == int((emit != 0).sum())
    jo, jc = je._compact_words(jnp.asarray(words), jnp.asarray(emit != 0))
    assert int(jc) == count
    assert np.array_equal(out[:count], np.asarray(jo)[:count])
    po, pc = tk.compact_words_plain(torch.from_numpy(words.view(np.int16)),
                                    torch.from_numpy(emit))
    assert int(pc.item()) == count
    assert np.array_equal(out, po.numpy().view(np.uint16))


def test_k3_look_back_under_many_schedules():
    """The look-back's offsets == the exclusive cumsum of the tiles'
    counts under 20 schedules of publication and look-back on 75 tiles of
    random counts (0 included)."""
    rng = np.random.default_rng(3)
    agg = rng.integers(0, _TILE + 1, 75)
    agg[::9] = 0
    want = np.cumsum(agg) - agg
    for _ in range(20):
        desc = [0] * len(agg)
        for t in rng.permutation(len(agg)):
            a = int(agg[t])
            desc[t] = ((_PRE << 62) | (a << 32) | a) if t == 0 \
                else (_AGG << 62) | (a << 32)
        for t in rng.permutation(len(agg)):
            if t:
                ex = _look_back(desc, t)
                assert ex == want[t]
                a = int(agg[t])
                desc[t] = (_PRE << 62) | (a << 32) | (ex + a)
