"""K16 pack_grid (csrc/transfer_pack.cu) and K10 window_batch
(csrc/window_batch.cu), their schedules on the CPU.

K16 gives each 4-slot group a thread, blocks of 256: one 4-byte load of
the group's bytes and one (mode 2), two (4) or three (6) byte stores of
the reference's unmasked ORs, truncated to the byte (_pack2_dev and
_pack4_dev work on u8, _pack6_dev on u32 cut into three bytes).

K10 gives a read one warp and lane l the candidates cp = l (mod 32),
ascending: residue l & 15, two lanes a residue on alternate candidates.
The read's 16-base words come from four codes a lane (a byte each,
assembled by shuffles), the reverse complement's from the forward words
(2-bit pairs reversed, shifted by Lp - len bases, complemented under the
mask).  Once a strand a lane builds its W + 1 frame words of the read and
of the folded mask at the shift 2 (cp & 15) (in registers up to W = 16,
a bucket of {2, 3, 4, 6, 8, 12, 16} words; above, W + 1 in shared
memory), then a candidate costs a staged reference word, XOR, the fold,
popcount and add a frame word.  The lanes go in rounds of 32 consecutive
positions; after each round the warp's best count bounds every later
candidate (a candidate stops once its partial count reaches it: frame
word 1, 16 whole bases, read first, the test after 1, 3, 5, ... words;
the warp stops at 0); the reverse scan starts bounded
by the forward best and is skipped at 0; a read with a degenerate base
skips both.  Two minimum reductions (the count, then the candidate among
the lanes holding it) give the first-occurrence argmin.

Plain mirrors of both schedules, kept here and never on the card path,
are held to the JAX package (_pack{2,4,6}_dev, _window_batch) and to the
port's plain versions (kernels.pack_grid_plain, kernels.window_batch_plain),
which the card tests (tests/test_torch_gpu.py) hold the kernels to.
Inputs come from numpy with a seed; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.align import hash as jh
from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.ops import kernels as tk

# csrc/transfer_pack.cu
_THREADS = 256
_JAX_PACK = {2: je._pack2_dev, 4: je._pack4_dev, 6: je._pack6_dev}
_U32 = np.uint64(0xFFFFFFFF)


def _u(x):
    return np.uint64(x)


# --- K16 ---------------------------------------------------------------------

def _k16_mirror(flat, mode):
    """pack_dense over a flat grid of n slots (n % 4 == 0): blocks of 256
    threads, thread t of block b on the 4-slot group g = 256 b + t; one
    4-byte load of the group's bytes a, b, c, d (slot k in byte k), the
    mode's branch, and its one (mode 2), two (4) or three (6) byte
    stores of the unmasked ORs, each truncated to its byte."""
    n = len(flat)
    groups = n // 4
    blocks = -(-groups // _THREADS)
    g = (np.arange(blocks)[:, None] * _THREADS
         + np.arange(_THREADS)[None, :]).reshape(-1)
    g = g[g < groups]
    assert np.array_equal(g, np.arange(groups))
    w = flat[:groups * 4].view("<u4").astype(np.uint64)       # grid4[g]
    a, b = w & _u(0xFF), (w >> _u(8)) & _u(0xFF)
    c, d = (w >> _u(16)) & _u(0xFF), w >> _u(24)
    if mode == 2:
        out = [a | (b << _u(2)) | (c << _u(4)) | (d << _u(6))]
    elif mode == 4:
        out = [a | (b << _u(4)), c | (d << _u(4))]
    else:
        v = a | (b << _u(6)) | (c << _u(12)) | (d << _u(18))
        out = [v, v >> _u(8), v >> _u(16)]
    return (np.stack(out, axis=1) & _u(0xFF)).astype(np.uint8).reshape(-1)


# grids of n slots around one 256-thread block (1,024 slots) and past
# many, with n % 16 in {0, 4, 8, 12}
_K16_N = [4, 8, 12, 16, 1024 - 4, 1024, 1024 + 8, 1024 * 37 + 12,
          16384 * 37 + 4]


@pytest.mark.parametrize("n", _K16_N)
@pytest.mark.parametrize("mode", [2, 4, 6])
def test_k16_mirror_matches_jax_and_plain(mode, n):
    """pack_dense's groups == _pack{2,4,6}_dev and pack_grid_plain on
    bytes over the full 0-255 range (the unmasked ORs, truncated), and on
    symbols below 2^mode == the host pack."""
    rng = np.random.default_rng(n * 7 + mode)
    for hi in (256, 1 << mode):
        g = rng.integers(0, hi, (n // 4, 4)).astype(np.uint8)
        want = np.asarray(_JAX_PACK[mode](jnp.asarray(g)))
        plain = tk.pack_grid_plain(torch.from_numpy(g), mode).numpy()
        assert np.array_equal(plain, want)
        if hi < 256:
            assert np.array_equal(want, je._pack_host(g, mode))
        assert np.array_equal(_k16_mirror(g.reshape(-1), mode),
                              want.reshape(-1))


def test_k16_mirror_on_a_wide_grid():
    """A (T, L) grid of 75 x 2052 (a row not a multiple of 16 slots) in
    each mode: the flat schedule == _pack{2,4,6}_dev row for row."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 256, (75, 2052)).astype(np.uint8)
    for mode in (2, 4, 6):
        want = np.asarray(_JAX_PACK[mode](jnp.asarray(g)))
        got = _k16_mirror(g.reshape(-1), mode)
        assert np.array_equal(got.reshape(want.shape), want)


# --- K10 ---------------------------------------------------------------------

_BIG = 1 << 28
_LOW = _u(0x55555555)
_BUCKETS = (2, 3, 4, 6, 8, 12, 16)


def _bucket(W):
    return next((k for k in _BUCKETS if W <= k), 0)


def _floor16(v):
    return np.floor_divide(v, 16)


def _funnel_r(lo, hi, sh):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> sh, 0 <= sh < 32."""
    return (((hi << _u(32)) | lo) >> sh.astype(np.uint64)) & _U32


def _funnel_l(lo, hi, sh):
    """__funnelshift_l: the high 32 bits of (hi:lo) << sh."""
    return ((((hi << _u(32)) | lo) << sh.astype(np.uint64)) >> _u(32)) & _U32


def _reverse_pairs(x):
    """__brev, then each 2-bit pair's bits swapped back."""
    b = np.zeros_like(x)
    for i in range(32):
        b |= ((x >> _u(i)) & _u(1)) << _u(31 - i)
    return ((b >> _u(1)) & _LOW) | ((b & _LOW) << _u(1))


def _read_words(codes, dege, lens):
    """The prologue: (B, W) forward words, mask words, their reverse
    complement, and whether a valid base is degenerate.  Lane q of a round
    packs bases 4q..4q+3 into a byte (MSB first) from one 4-byte load;
    four lanes OR their bytes into a word (the shuffles)."""
    B, Lp = codes.shape
    nq, W = Lp // 4, Lp // 16
    q = np.arange(nq)
    nv = np.clip(lens[:, None] - 4 * q[None, :], 0, 4)
    keep = np.where(nv == 4, 0xFFFFFFFF,
                    (1 << (8 * nv)) - 1).astype(np.uint64)
    x = codes.view("<u4").astype(np.uint64) & keep
    dg = ((dege.view(np.uint8).view("<u4").astype(np.uint64) & keep) != 0)
    p = (((x & _u(3)) << _u(6)) | ((x >> _u(4)) & _u(0x30))
         | ((x >> _u(14)) & _u(0xC)) | ((x >> _u(24)) & _u(3)))
    pm = (_u(0xFF00) >> (2 * nv).astype(np.uint64)) & _u(0xFF)
    at = (8 * (3 - (q & 3))).astype(np.uint64)
    rw = np.bitwise_or.reduce((p << at).reshape(B, W, 4), axis=2)
    mw = np.bitwise_or.reduce((pm << at).reshape(B, W, 4), axis=2)
    # the reverse complement from the forward words alone
    D = Lp - lens
    dq, dsh = D >> 4, 2 * (D & 15)
    R = np.concatenate([_reverse_pairs(rw[:, ::-1]),
                        np.zeros((B, 2), np.uint64)], axis=1)
    k = np.arange(W)[None, :]
    hi = np.take_along_axis(R, np.minimum(k + dq[:, None], W), axis=1)
    lo = np.take_along_axis(R, np.minimum(k + dq[:, None] + 1, W + 1),
                            axis=1)
    rr = _funnel_l(lo, hi, np.broadcast_to(dsh[:, None], (B, W))) ^ mw
    return rw, mw, rr, dg.any(axis=1)


def _frames(words, nj):
    """Each lane's frame words j = 0..nj at the shift 2 (l & 15): (B, 32,
    nj + 1); the words past W are 0."""
    B, W = words.shape
    z = np.zeros((B, 1), np.uint64)
    ext = np.concatenate([z, words, np.zeros((B, nj + 1 - W), np.uint64)],
                         axis=1)                 # ext[j + 1] = word j
    sh = np.broadcast_to((2 * (np.arange(32) & 15))[None, :, None],
                         (B, 32, nj + 1))
    lo = np.broadcast_to(ext[:, None, 1:nj + 2], (B, 32, nj + 1))
    hi = np.broadcast_to(ext[:, None, 0:nj + 1], (B, 32, nj + 1))
    return _funnel_r(lo, hi, sh)


def _scan(words, mw, win, c0, base, lens, ref_len, C, bound0, active, nj,
          exits=True, stats=None):
    """One strand's scan, lane by lane and round by round: (mis, cand)
    per read; mis = _BIG where no candidate is below bound0."""
    B = len(c0)
    nwin = win.shape[1]
    F = _frames(words, nj)
    M = _frames(mw, nj) & _LOW
    lanes = np.arange(32)[None, :]
    first = (lanes - c0[:, None]) & 31                  # (B, 32)
    o = _floor16(c0[:, None] + first) - base[:, None]
    bound = np.where(active, bound0, 0).astype(np.int64)
    best = np.full((B, 32), _BIG, np.int64)
    bj = np.full((B, 32), 0xFFFFFFFF, np.int64)
    j = np.arange(nj + 1)
    order = np.r_[1, 0, 2:nj + 1]
    for i in range((C + 31) // 32):
        alive = bound > 0
        if not alive.any():
            break
        cj = first + 32 * i
        cp = c0[:, None] + cj
        ok = (alive[:, None] & (cj < C) & (cp >= 0)
              & (cp + lens[:, None] <= ref_len))
        idx = o + 2 * i
        assert (idx[ok] + nj < nwin).all() and (idx[ok] >= 0).all()
        rf = np.take_along_axis(
            win[:, None, :].repeat(32, 1),
            np.clip(idx[:, :, None] + j, 0, nwin - 1), axis=2)
        x = F ^ rf
        cnt = np.bitwise_count((x | (x >> _u(1))) & M).astype(np.int64)
        # frame word 1 first, then 0, 2, 3, ...; tests after 1, 3, 5 words
        part = np.cumsum(cnt[:, :, order], axis=2)
        stop = ((j & 1) == 0) & (part >= bound[:, None, None]) & exits
        last = np.where(stop.any(2), np.argmax(stop, 2), nj)
        m = np.take_along_axis(part, last[:, :, None], axis=2)[:, :, 0]
        if stats is not None:
            stats["words"] += int((last + 1)[ok].sum())
            stats["full"] += int(ok.sum()) * (nj + 1)
        rec = ok & (m < bound[:, None])
        best = np.where(rec, m, best)
        bj = np.where(rec, cj, bj)
        bound = np.where(alive, np.minimum(bound, best.min(1)), bound)
    wbest = best.min(1)
    if stats is not None:           # several lanes hold the warp's best
        stats["ties"] += int((((best == wbest[:, None]).sum(1) > 1)
                              & (wbest < _BIG)).sum())
    cand = np.where(best == wbest[:, None], bj, 0xFFFFFFFF).min(1)
    return wbest, cand


def _k10_mirror(packed, ref_len, codes, dege, lengths, centers, C, max_mis,
                exits=True, stats=None):
    """window_batch over a (B, Lp) batch: (mapped, pos, rev, mask)."""
    B, Lp = codes.shape
    W = Lp // 16
    kw = _bucket(W)
    nj = kw or W
    lens = np.clip(lengths.astype(np.int64), 0, Lp)
    rw, mw, rr, has_dege = _read_words(codes, dege, lens)
    c0 = centers.astype(np.int64) - C // 2
    base = _floor16(c0)
    nwin = (C + 15) // 16 + nj + 2
    gi = base[:, None] + np.arange(nwin)
    pk = packed.astype(np.uint64)
    win = np.where((gi >= 0) & (gi < len(pk)),
                   pk[np.clip(gi, 0, len(pk) - 1)], _u(0))
    mis_f, jf = _scan(rw, mw, win, c0, base, lens, ref_len, C,
                      np.full(B, _BIG), ~has_dege, nj, exits, stats)
    act_r = ~has_dege & (mis_f > 0)
    mis_r, jr = _scan(rr, mw, win, c0, base, lens, ref_len, C, mis_f, act_r,
                      nj, exits, stats)
    mis_r = np.where(act_r, mis_r, _BIG)
    use_rev = mis_r < mis_f
    mis = np.where(use_rev, mis_r, mis_f)
    jb = np.where(use_rev, jr, jf)
    pos = np.where(mis >= _BIG, c0, c0 + jb)
    mapped = (mis <= max_mis) & ~has_dege
    # the mask from the staged window, the effective strand's words
    ew = np.where(use_rev[:, None], rr, rw)
    i = np.arange(Lp)[None, :]
    e = (np.take_along_axis(ew, np.broadcast_to(i >> 4, (B, Lp)), axis=1)
         >> (2 * (15 - (i & 15))).astype(np.uint64)) & _u(3)
    idx = np.where(mapped[:, None], pos[:, None] + i, 0)
    wi = (idx >> 4) - base[:, None]
    live = mapped[:, None] & (i < lens[:, None])
    assert ((wi[live] >= 0) & (wi[live] < nwin)).all()
    rb = (np.take_along_axis(win, np.clip(wi, 0, nwin - 1), axis=1)
          >> (2 * (15 - (idx & 15))).astype(np.uint64)) & _u(3)
    mask = live & (e != rb)
    return mapped, pos.astype(np.int32), use_rev & mapped, mask


def _pack_ref(ref):
    """The 2-bit reference as the aligner's index packs it: MSB-first
    u32 words, one spare word."""
    n = -(-len(ref) // 16) + 1
    pad = np.zeros(n * 16, np.uint64)
    pad[:len(ref)] = ref
    sh = (2 * (15 - np.arange(16))).astype(np.uint64)
    return (pad.reshape(n, 16) << sh).sum(axis=1).astype(np.uint32)


@pytest.fixture(scope="module")
def window_ref():
    """A seeded 40 kbp reference with a tandem repeat (200 bases twice
    from 20,000: exact ties 200 apart), a period-8 run at 25,000 (exact
    ties inside one round of 32 candidates) and a reverse-complement
    palindrome at 30,000 (a forward/RC tie)."""
    rng = np.random.default_rng(23)
    ref = rng.integers(0, 4, 40_000).astype(np.uint8)
    ref[20_200:20_400] = ref[20_000:20_200]
    ref[25_000:25_400] = np.tile(ref[25_000:25_008], 50)
    x = ref[30_000:30_200].copy()
    ref[30_200:30_400] = (3 - x)[::-1]
    return ref, _pack_ref(ref)


def _window_batch(rng, ref, lp, C, B=48):
    """B reads in a (B, lp) grid with window centers: mapped forward and
    reverse (a few substitutions), random, outside the window, windows at
    both ends of the reference, exact ties (the repeat, the period-8 run,
    the palindrome), lengths 0 and lp, and reads with an N."""
    G = len(ref)
    codes = np.zeros((B, lp), np.uint8)
    dege = np.zeros((B, lp), bool)
    lengths = np.zeros(B, np.int32)
    centers = np.zeros(B, np.int32)
    for b in range(B):
        kind = b % 8
        L = lp if b % 11 == 3 else int(rng.integers(1, lp + 1))
        if b == 13:
            L = 0
        s = int(rng.integers(C + 5, G - C - L - 5))
        # the true start's offset in the window [center - C/2, ... + C)
        d = int(rng.integers(0, C))
        if kind == 3:                     # the left end
            s = int(rng.integers(0, 12))
        elif kind == 4:                   # the right end
            s = G - L - int(rng.integers(0, 12))
        elif kind == 6 and b % 16 == 6:   # the repeat: copies 200 apart
            L = min(L, 200)
            s = 20_000 + int(rng.integers(0, 201 - L))
            d = min(d, max(C - 201, 0))
        elif kind == 6:                   # the period-8 run
            L = min(L, 300)
            s = 25_000 + int(rng.integers(0, 401 - L))
            d = min(d, max(C - 33, 0))
        elif kind == 7:                   # the palindrome
            L = min(L, 400)
            s = 30_200 - L // 2
        r = ref[s:s + L].copy()
        if kind in (0, 1):
            e = rng.random(L) < 0.04
            r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
        elif kind == 5:
            r = rng.integers(0, 4, L).astype(np.uint8)
        elif kind == 7 and L:
            r[L // 3] = (r[L // 3] + 1) % 4
        if kind == 1 or (kind == 0 and b % 16 == 8):
            r = (3 - r)[::-1].copy()
        if kind == 2:                     # outside the window
            d = C + 3
        codes[b, :L] = r
        lengths[b] = L
        centers[b] = s - d + C // 2
        if L and b % 10 == 9:             # an N
            dege[b, int(rng.integers(0, L))] = True
    return codes, dege, lengths, centers


# every Lp (W = 2, 3, 8 and 16 in registers, 24 in shared memory) and
# every C at least once; Lp = 384 with C = 4096 is the card tests' case
_K10_CASES = [(32, 1), (32, 4096), (48, 17), (48, 188), (128, 188),
              (128, 1128), (256, 1128), (256, 17), (384, 188)]


@pytest.mark.parametrize("lp,C", _K10_CASES)
def test_k10_mirror_matches_jax_and_plain(window_ref, lp, C):
    """The residue-class scan == _window_batch and window_batch_plain on
    mapped and on the mapped reads' pos, strand and mask; the exits fire
    and change no decision (== the scan with no exit); reads whose best
    count several lanes hold take the lowest candidate."""
    ref, packed = window_ref
    rng = np.random.default_rng(lp * 10_000 + C)
    codes, dege, lengths, centers = _window_batch(rng, ref, lp, C)
    want = [np.asarray(x) for x in jh._window_batch(
        lp, C, 7, jnp.asarray(packed), jnp.int32(len(ref)),
        jnp.asarray(codes), jnp.asarray(dege), jnp.asarray(lengths),
        jnp.asarray(centers))]
    plain = [x.numpy() for x in tk.window_batch(
        torch.from_numpy(packed.view(np.int32)), len(ref),
        torch.from_numpy(codes), torch.from_numpy(dege),
        torch.from_numpy(lengths), torch.from_numpy(centers), C, 7)]
    stats = {"words": 0, "full": 0, "ties": 0}
    got = _k10_mirror(packed, len(ref), codes, dege, lengths, centers, C, 7,
                      stats=stats)
    full = _k10_mirror(packed, len(ref), codes, dege, lengths, centers, C, 7,
                       exits=False)
    m = want[0]
    assert m.sum() >= 8 and not m[dege.any(1)].any()
    for other in (plain, list(full)):
        assert np.array_equal(other[0], m)
        for a, b in zip(other[1:], want[1:]):
            assert np.array_equal(a[m], b[m])
    assert np.array_equal(got[0], m)
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a[m], b[m])
    assert got[2][m].any() or C < 32
    if C >= 32:                     # the exits read fewer words
        assert stats["words"] < stats["full"] * (0.8 if lp > 32 else 1)
    assert stats["ties"] or C == 1  # lanes tied at the best: the reduction


def test_k10_lanes_partition_the_window():
    """Every lane's candidates cp = c0 + first + 32 i below C: each of the
    C candidates once, lane l on cp = l (mod 32) (residue l & 15), the two
    lanes of a residue on alternate candidates of it, each ascending; a
    round's candidates all right of the round before."""
    rng = np.random.default_rng(3)
    for C in (1, 17, 31, 32, 33, 188, 1128, 4096):
        for c0 in list(rng.integers(-5000, 5000, 6)) + [0, -1, 15, 16]:
            lanes = np.arange(32)
            first = (lanes - c0) & 31
            rounds = (C + 31) // 32
            cj = first[:, None] + 32 * np.arange(rounds)[None, :]
            live = cj < C
            assert np.array_equal(np.sort(cj[live]), np.arange(C))
            cp = c0 + cj
            assert ((cp % 32) == lanes[:, None])[live].all()
            for r in range(16):
                both = np.sort(np.concatenate([cp[r][live[r]],
                                               cp[r + 16][live[r + 16]]]))
                assert (np.diff(both) == 16).all()
            for i in range(1, rounds):
                if live[:, i].any():
                    assert cj[live[:, i], i].min() > cj[live[:, i - 1],
                                                        i - 1].max()


@pytest.mark.parametrize("lp", [32, 48, 128, 256, 384])
def test_k10_words_from_four_codes_and_the_reverse_from_the_forward(lp):
    """The prologue's forward, mask and reverse-complement words (the
    latter from the forward words alone) == the port's _pack_words of the
    codes and of _rc_grid's reverse complement, at every length from 0 to
    Lp, and the degenerate flag only where a valid base has one."""
    rng = np.random.default_rng(lp)
    B = lp + 1
    lens = np.arange(B).astype(np.int64)
    codes = rng.integers(0, 4, (B, lp)).astype(np.uint8)
    codes[np.arange(lp)[None, :] >= lens[:, None]] = 0
    dege = np.zeros((B, lp), bool)
    dege[5::7, -1] = True                 # past the length but for lp
    dege[3::7, 0] = True
    rw, mw, rr, dg = _read_words(codes, dege, lens)
    c, d, ln = (torch.from_numpy(a) for a in (codes, dege, lens))
    valid = torch.arange(lp)[None, :] < ln[:, None]
    want_f, want_m = tk._pack_words(c, valid)
    rc, _ = tk._rc_grid(c, d, ln)
    want_r, _ = tk._pack_words(rc, valid)
    assert np.array_equal(rw, want_f.numpy() & 0xFFFFFFFF)
    assert np.array_equal(mw, want_m.numpy() & 0xFFFFFFFF)
    assert np.array_equal(rr, want_r.numpy() & 0xFFFFFFFF)
    assert np.array_equal(dg, (dege & valid.numpy()).any(1))


def test_k10_frame_bucket():
    """W -> the register bucket (lp_bucket's W up to 16), 0 above: the
    frame words then live in shared memory."""
    assert [_bucket(w) for w in range(1, 18)] == [
        2, 2, 3, 4, 6, 6, 8, 8, 12, 12, 12, 12, 16, 16, 16, 16, 0]
