"""The decompositions K5's and K6's designs rest on, on the CPU.

K5 (csrc/adapt_encode.cu) does not walk the waves in order: it computes
every slot's context, groups the slots by context row with a stable sort
(so each row's events stay in wave order), and walks each row on its own
by wave groups: every event of a group quantized from the row before the
group, then the group's adds, then the halving.  K6 (csrc/adapt_decode.cu)
finds a symbol by counting the row's prefix sums at or below a threshold,
without branching on the data: the block of 32 counts (from the row's
block sums, for rows over 44 counts), then the 16-byte segment, holding
the threshold, then that segment's four counts.

Each case makes its input with numpy from a seed.  A plain mirror of K5's
row walk (in this file, never on the card path) is held to the JAX
engine's _pass1 and to the port's adapt_encode_walk_plain, which the card
tests (tests/test_torch_gpu.py) hold the kernel to; a scalar mirror of
K6's search is held to the reference's sum(F[1:] <= low).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.models import base as jb
from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.config import PROB_BITS, RANS_M
from fastqueeze_tpu_torch.models import base as tb
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import kernels as tk
from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid

# the seven adaptive models of the card tests, and two that stress the
# walk: a cap that halves every touched row, every event on one row
_MODELS = {
    "seq_o10": ("SeqModel", dict(alphabet=4, init=3, inc=1, cap=253,
                                 order=10)),
    "fqz_q2": ("QualModel", dict(alphabet=40, init=1, inc=8, cap=8192,
                                 qlevel=2)),
    "fqz_q3": ("QualModel", dict(alphabet=40, init=1, inc=8, cap=8192,
                                 qlevel=3)),
    "chain_k4": ("QualModel", dict(alphabet=8, init=1, inc=16, cap=8192,
                                   k=4, ctx_base=7, hash_bits=12,
                                   pos_bits=3)),
    "order1_byte": ("Order1ByteModel", dict(alphabet=256, init=1, inc=16,
                                            cap=8192)),
    "order0_flag": ("CtxModel", dict(alphabet=2, init=1, inc=16, cap=8192)),
    "flat_4": ("FlatModel", dict(alphabet=256, init=1, inc=16, cap=8192,
                                 n_ctx=4)),
    "seq_o2_small_cap": ("SeqModel", dict(alphabet=4, init=1, inc=5, cap=8,
                                          order=2)),
}
_L = 64


def _models(name):
    cls, kw = _MODELS[name]
    return getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)


def _stream(name, shape, seed):
    """(counts per read, read-major symbols, flat contexts or None)."""
    jm, _ = _models(name)
    rng = np.random.default_rng(seed)
    if shape == "duplicate_heavy":
        # reads of one repeated base, their starts staggered: past the
        # first `order` bases every read sits on the all-zero history, so
        # most events of every wave land on one row
        counts = rng.integers(20, 60, 3 * _L).astype(np.int64)
        syms = np.zeros(int(counts.sum()), np.uint8)
        syms[::97] = 2
    else:
        counts = rng.integers(0, 60, 300).astype(np.int64)
        counts[::11] = 0
        if shape == "empty":
            counts[:] = 0
        syms = rng.integers(0, jm.alphabet, int(counts.sum())).astype(
            np.uint8)
    ctx = (rng.integers(0, jm.n_ctx, len(syms)).astype(np.int32)
           if name == "flat_4" else None)
    return counts, syms, ctx


def _counts0(model, seed):
    """A starting table with every row at or under cap."""
    rng = np.random.default_rng(seed)
    per = max(1, model.cap // model.alphabet)
    return rng.integers(1, per + 1, (model.n_ctx, model.alphabet)).astype(
        np.int32)


def _row_walk(g, cg, model, n_halve, ctxg=None, counts0=None):
    """K5's decomposition, plainly: every slot's context, the valid slots
    sorted stably by context (each row's run keeps slot order, so wave
    order), then each row walked alone by wave groups from its starting
    counts.  Returns the (T, L) int64 start | end << 16, 0 at padding."""
    T, L = g.shape
    valid, aux = tk._walk_aux(T, cg, ctxg)
    ctx = model.context_grids(g, aux).reshape(-1).numpy()
    syms = g.reshape(-1).numpy().astype(np.int64)
    slots = np.flatnonzero(valid.reshape(-1).numpy())
    ev = slots[np.argsort(ctx[slots], kind="stable")]
    keys = ctx[ev]
    sf = np.zeros(T * L, np.int64)
    heads = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]]) if len(ev) \
        else np.zeros(0, np.int64)
    for a, b in zip(heads, np.r_[heads[1:], len(ev)]):
        row = (counts0[keys[a]].astype(np.int64) if counts0 is not None
               else np.full(model.alphabet, model.init, np.int64))
        run = ev[a:b]
        t = run // L
        assert (np.diff(t) >= 0).all()
        g0 = np.flatnonzero(np.r_[True, t[1:] != t[:-1]])
        for ga, gb in zip(g0, np.r_[g0[1:], len(run)]):
            grp, s = run[ga:gb], syms[run[ga:gb]]
            cum = np.r_[0, np.cumsum(row)]
            C = cum[-1]
            sf[grp] = (((cum[s] << PROB_BITS) // C)
                       | (((cum[s + 1] << PROB_BITS) // C) << 16))
            np.add.at(row, s, model.inc)
            for _ in range(n_halve):
                if row.sum() <= model.cap:
                    break
                row = (row + 1) >> 1
    return sf.reshape(T, L)


def _heaviest_groups(g, cg, model):
    """Wave groups of the row with the most events."""
    T = g.shape[0]
    valid, aux = tk._walk_aux(T, cg, None)
    c = model.context_grids(g, aux)
    rows, n = torch.unique(c[valid], return_counts=True)
    top = rows[n.argmax()]
    return int(((c == top) & valid).any(dim=1).sum())


def _jax_sf(jm, g, cg, n_halve, ctxg=None, counts0=None):
    """The JAX engine's _pass1 over the same grids, packed as K5 packs it
    (start | end << 16, 0 at padding)."""
    T = g.shape[0]
    valid, aux = je._device_aux(T, jnp.asarray(cg.numpy()))
    if ctxg is not None:
        aux = dict(aux, ctx=jnp.asarray(ctxg.numpy()))
    syms = jnp.asarray(g.numpy())
    ctx = je._ctx_grids(jm, syms, aux)
    c0 = (je.init_counts(jm) if counts0 is None else jnp.asarray(counts0))
    start, freq, _ = je._pass1(jm, n_halve, c0, ctx, syms, valid)
    start = np.asarray(start).astype(np.int64)
    end = start + np.asarray(freq).astype(np.int64)
    return np.where(np.asarray(valid), start | (end << 16), 0)


def _grids(counts, syms, ctx):
    lay = make_layout(counts, _L)
    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(te._counts_grid(counts, _L))
    ctxg = None if ctx is None else torch.from_numpy(to_grid(lay, ctx))
    return g, cg, ctxg


_CASES = ([(name, "ragged", False) for name in sorted(_MODELS)]
          + [("seq_o10", "empty", False), ("fqz_q2", "empty", False),
             ("seq_o10", "duplicate_heavy", False),
             ("seq_o10", "duplicate_heavy", True),
             ("seq_o2_small_cap", "ragged", True),
             ("fqz_q2", "ragged", True), ("order1_byte", "ragged", True)])


@pytest.mark.parametrize("name,shape,from_table", _CASES,
                         ids=[f"{n}-{s}{'-counts0' if c else ''}"
                              for n, s, c in _CASES])
def test_row_walk_matches_pass1_and_plain(name, shape, from_table):
    """The row-parallel walk == the JAX _pass1 == adapt_encode_walk_plain,
    bit for bit, on ragged streams with zero-length reads, empty streams,
    the duplicate-heavy stream, a cap that halves a row whenever it is
    touched, and from a caller's table."""
    jm, tm = _models(name)
    counts, syms, ctx = _stream(name, shape, len(name) + len(shape))
    g, cg, ctxg = _grids(counts, syms, ctx)
    nh = te._n_halve(tm, _L)
    c0 = _counts0(tm, 5) if from_table else None
    mirror = _row_walk(g, cg, tm, nh, ctxg, c0)
    plain = tk._u32(tk.adapt_encode_walk_plain(
        g, cg, tm, nh, ctxg, None if c0 is None else torch.from_numpy(c0)))
    assert np.array_equal(mirror, plain.numpy())
    if g.shape[0]:
        assert np.array_equal(mirror, _jax_sf(jm, g, cg, nh, ctxg, c0))
    waves = int(tk._walk_aux(g.shape[0], cg, None)[0].any(dim=1).sum())
    if shape == "duplicate_heavy":       # one row takes most waves
        assert 2 * _heaviest_groups(g, cg, tm) > waves
    if name == "order0_flag":            # one row, every wave with events
        assert _heaviest_groups(g, cg, tm) == waves > 0
    if name == "seq_o2_small_cap":       # every touched row halves:
        assert tm.alphabet + tm.inc > tm.cap  # no row falls below A


# --- K6's count search ----------------------------------------------------

def _k6_search(counts, lows, head, nseg=12, direct_a=44):
    """csrc/adapt_decode.cu row_search over one row of int32 counts, for
    every slot value in ``lows`` at once, th = ((low + 1) * C - 1) >> 14:
    a row of more than direct_a counts first picks, from the sums of its
    blocks of 32, the last block whose first prefix is at or below th;
    then, over the counts [lo, hi) searched, in nseg 16-byte segments
    from the aligned address head bytes before count lo, the last segment
    whose first prefix is at or below th; every count before it is
    counted, and its four counts are counted one by one.  Returns (sym,
    start, freq) arrays."""
    A = len(counts)
    C = int(counts.sum())
    th = ((lows + 1) * C - 1) >> PROB_BITS
    cum = np.zeros_like(lows)
    cnt = np.zeros_like(lows)
    en = np.full_like(lows, C)
    lo, hi = np.zeros_like(lows), np.full_like(lows, A)
    if A > direct_a:
        nb = (A + 31) // 32
        b = [int(counts[32 * k:32 * k + 32].sum()) for k in range(8)]
        j = np.zeros_like(lows)
        go = np.ones(lows.shape, bool)
        for k in range(1, 8):
            nxt = cum + b[k - 1]
            inn = go & (k < nb)
            take = inn & (nxt <= th)
            cum = np.where(take, nxt, cum)
            j = np.where(take, k, j)
            en = np.where(inn & ~take, nxt, en)
            go = take
        cnt = np.where(j > 0, 32 * j - 1, 0)
        lo, hi = 32 * j, np.minimum(A, 32 * j + 32)

    def val(k):
        return np.where((k >= lo) & (k < hi), counts[np.clip(k, 0, A - 1)],
                        0)

    P, Pb, Pn, best = cum, cum, en, np.zeros_like(lows)
    for i in range(nseg):
        k = lo + ((16 * i - head) >> 2)
        sel = (k < hi) & (P <= th)
        best = np.where(sel, i, best)
        Pb = np.where(sel, P, Pb)
        Pn = np.where((k < hi) & ~sel, np.minimum(Pn, P), Pn)
        P = P + val(k) + val(k + 1) + val(k + 2) + val(k + 3)
    k = lo + ((16 * best - head) >> 2)
    cnt = cnt + np.maximum(0, np.maximum(k, lo) - np.maximum(lo, 1))
    c, st, en = Pb, np.zeros_like(lows), Pn
    for w in range(4):
        kk = k + w
        inr = (kk >= lo) & (kk < hi)
        le = inr & (kk >= 1) & (c <= th)
        cnt = cnt + le
        st = np.where(le, c, st)
        en = np.where(inr & (kk >= 1) & (c > th), np.minimum(en, c), en)
        c = np.where(inr, c + counts[np.clip(kk, 0, A - 1)], c)
    start = (st << PROB_BITS) // C
    return cnt, start, ((en << PROB_BITS) // C) - start


def _ref_search(F, lows):
    """The reference's decode: sym = sum(F[1:A] <= low), (F[sym],
    F[sym + 1] - F[sym])."""
    sym = (F[None, 1:-1] <= lows[:, None]).sum(axis=1)
    return sym, F[sym], F[sym + 1] - F[sym]


def _rows(A, seed):
    """Rows whose quantized F has equal neighbours: zero counts (alone,
    in runs, leading and trailing) and totals far above 2^14 / A, where
    floor(cum * 2^14 / C) repeats."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(1, 9, A), rng.integers(0, 3, A),
            np.r_[np.zeros(A - 1, np.int64), 5],
            np.r_[7, np.zeros(A - 1, np.int64)],
            rng.integers(0, 2, A) * rng.integers(1, 40000, A)]
    r = rng.integers(1, 30, A)
    r[A // 3: A // 3 + max(1, A // 4)] = 0
    rows.append(r)
    return [np.asarray(x, np.int64) for x in rows if x.sum() > 0]


@pytest.mark.parametrize("A,nseg", [(2, 12), (4, 2), (8, 12), (40, 12),
                                    (44, 12), (45, 12), (48, 12), (256, 12)])
def test_k6_count_search_equals_reference(A, nseg):
    """On rows with equal neighbouring F entries, K6's search (whole rows
    up to 44 counts, block sums above) gives the reference's symbol,
    start and freq for every slot value low, at each of the row's
    possible offsets in a 16-byte segment."""
    lows = np.arange(RANS_M, dtype=np.int64)
    ties = 0
    for row in _rows(A, A):
        cum = np.r_[0, np.cumsum(row)]
        F = (cum << PROB_BITS) // cum[-1]
        ties += bool((np.diff(F) == 0).any())
        want = _ref_search(F, lows)
        for head in (0, 4, 8, 12):
            got = _k6_search(row, lows, head, nseg)
            for g, w in zip(got, want):
                assert np.array_equal(g, w), head
    assert ties >= 4
