"""The schedule of the redesigned K12 (csrc/semi_decode.cu), on the CPU.

K12 decodes a semi-adaptive stream a chunk at a time, two launches a
chunk: a boundary pass (up to n_halve halvings of each visited row over
cap, none before the first chunk, then its snapshot F[s] | F[s+1] << 16)
over every row before the first chunk, and at every later boundary over
only the rows the last chunk's adds touched and the rows the last
boundary left over cap; then the chunk's waves on one thread-block
cluster, as K4
decodes a frozen stream: each lane's walk (model state, cursor, rANS
state) and the word offset carried in scratch from the last chunk's
launch; per wave each live lane's snapshot row, the symbol by counting
the row's starts F[s] <= the state's slot (s in 1..A-1), the rank of the
lanes that renormalize in lane order (the cluster's thread order), the
clamped word read words[min(off + rank, W - 1)], the count adds and the
touched rows.  After the last chunk a halving-only pass over the same
set.

A plain mirror of that schedule, kept here and never on the card path, is
held to the JAX engine's _decode_semi (symbols and final counts) and to
the port's plain version (kernels.semi_decode_plain, which the card tests
hold the kernel to), at chunks 16 and 32 with 40 lanes, from init, from a
trained table and from a counts0 with a row that stays over cap after
n_halve halvings (one such row read by the stream, one never) and rows
never touched; and the count search on snapshot rows with zero-frequency
symbols is held to the reference's binary search.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.models import base as jb
from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.config import RANS_L, RANS_M
from fastqueeze_tpu_torch.models import base as tb
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import kernels as tk

_P = dict(lanes_min=8, lanes_max=64, lane_target_symbols=256)
_L = 40
_MODELS = {
    "seq_o6": ("SeqModel", dict(alphabet=4, init=3, inc=1, cap=253,
                                order=6)),
    "fqz_q2": ("QualModel", dict(alphabet=40, init=1, inc=8, cap=8192,
                                 qlevel=2)),
}


@functools.lru_cache(maxsize=None)
def _stream(name, seed=7):
    """(JAX model, port model, (T, L) grid, (J, L) read lengths, valid,
    JAX aux, a table the JAX trainer made from other symbols); made once
    a model, read only."""
    cls, kw = _MODELS[name]
    jm, tm = getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 90, 160).astype(np.int64)
    counts[::13] = 0
    n = int(counts.sum())

    def draw():
        if cls == "QualModel":      # random-walk ranks: repetitive contexts
            return np.clip(np.cumsum(rng.integers(-2, 3, n)) % 80 - 20, 0,
                           jm.alphabet - 1).astype(np.uint8)
        return rng.integers(0, jm.alphabet, n).astype(np.uint8)

    syms, train = draw(), draw()
    table = np.array(je.train_counts(jm, JParams(**_P), train, counts))
    lay = te.make_layout(counts, _L)
    g = te.to_grid(lay, syms)
    cg = te._counts_grid(counts, _L)
    valid, aux = je._device_aux(lay.T, jnp.asarray(cg))
    return jm, tm, g, cg, valid, aux, table


def _start(name, jm, g, valid, aux, table, start):
    """counts0 of a case: None (init), the trained table, or the trained
    table with two rows of total 2^21 (over cap after many halvings; the
    JAX quantization is exact up to 2^22), one a context the stream reads
    most, one a context it never reads."""
    if start == "init":
        return None
    if start == "trained":
        return table
    ctx = np.asarray(je._ctx_grids(jm, jnp.asarray(g), aux))[
        np.asarray(valid)]
    used = np.bincount(ctx, minlength=jm.n_ctx)
    big = table.copy()
    big[int(used.argmax())] = (1 << 21) // jm.alphabet
    big[int(np.flatnonzero(used == 0)[0])] = (1 << 21) // jm.alphabet
    return big


def _halve(counts, cap, n):
    """_rescale_full's halvings on the given rows."""
    for _ in range(n):
        tot = counts.sum(dim=1, keepdim=True)
        counts = torch.where(tot > cap, (counts + 1) >> 1, counts)
    return counts


def _boundary(counts, snap, rows, cap, n, write_snap=True):
    """A boundary pass over ``rows`` in place; returns the rows it left
    over cap (the next boundary's list)."""
    r = _halve(counts[rows], cap, n)
    counts[rows] = r
    if write_snap:
        snap[rows] = tk._snapshot(r.to(torch.int32))
    return rows[r.sum(dim=1) > cap]


def _count_search(rows, low):
    """csrc/semi_decode.cu row_search on (n, A) snapshot words F[s] |
    F[s+1] << 16: sym = #{s in 1..A-1 : F[s] <= low}, start the largest of
    F[0] and those starts, end the smallest of F[A] (the last word's high
    half) and the starts above low."""
    F = rows & 0xFFFF
    mid = F[:, 1:]
    le = mid <= low[:, None]
    start = torch.maximum(F[:, 0], torch.where(le, mid, 0).max(dim=1).values)
    end = torch.minimum(rows[:, -1] >> 16,
                        torch.where(le, 0xFFFF, mid).min(dim=1).values)
    return le.sum(dim=1), start, end - start


def _binary_search(rows, low):
    """_decode_semi's search: the largest s with F[s] <= low in
    ceil(log2 A) steps, (start, freq) from that word."""
    n, A = rows.shape
    lo = torch.zeros(n, dtype=torch.int64)
    hi = torch.full((n,), A - 1, dtype=torch.int64)
    at = torch.arange(n)
    for _ in range(max(1, (A - 1).bit_length())):
        m = (lo + hi + 1) >> 1
        le = (rows[at, m] & 0xFFFF) <= low
        lo, hi = torch.where(le, m, lo), torch.where(le, hi, m - 1)
    v = rows[at, lo]
    return lo, v & 0xFFFF, (v >> 16) - (v & 0xFFFF)


def _cluster_mirror(states0, words, cg, T, tm, nh, chunk, counts0):
    """K12's launches: per chunk the boundary pass over every row (before
    the first) or over the ring's rows and the over-cap list, then the
    chunk's waves from the carry the last chunk's launch stored, writing
    the ring."""
    L = states0.shape[0]
    A = tm.alphabet
    valid, aux = tk.device_aux_plain(T, cg)
    counts = (torch.full((tm.n_ctx, A), tm.init, dtype=torch.int64)
              if counts0 is None else torch.from_numpy(counts0).long())
    W = words.shape[0]
    w16 = tk._u16(words)
    out = torch.full((T, L), 255, dtype=torch.uint8)
    carry = (tm.lane_init(L, "cpu"), tk._u32(states0), 0)
    snap = torch.zeros_like(counts)
    over = _boundary(counts, snap, torch.arange(tm.n_ctx), tm.cap, 0)
    ring = None
    for t0 in range(0, T, chunk):
        if t0:
            rows = torch.unique(torch.cat([ring[ring >= 0], over]))
            over = _boundary(counts, snap, rows, tm.cap, nh)
        ring = torch.full((chunk, L), -1, dtype=torch.int64)
        st, x, off = carry
        for t in range(t0, t0 + chunk):
            vld = valid[t]
            aux_t = {k: v[t] for k, v in aux.items()}
            ctx = tm.context(st, aux_t).long()
            low = x & (RANS_M - 1)
            sym, start, f = _count_search(snap[ctx], low)
            xn = (f * (x >> 14) + low - start) & 0xFFFFFFFF
            need = (xn < RANS_L) & vld
            rank = torch.cumsum(need.long(), dim=0) - need.long()
            wv = w16[torch.clamp(off + rank, max=W - 1)]
            xn = torch.where(need, ((xn << 16) | wv) & 0xFFFFFFFF, xn)
            x = torch.where(vld, xn, x)
            off += int(need.sum())
            out[t] = torch.where(vld, sym, 0).to(torch.uint8)
            ring[t - t0] = torch.where(vld, ctx, -1)
            counts.index_put_((ctx[vld], sym[vld]),
                              torch.full_like(sym[vld], tm.inc),
                              accumulate=True)
            new = tm.update(st, sym, aux_t)
            st = {k: torch.where(vld, new[k], st[k]) for k in st}
        carry = (st, x, off)
    rows = torch.unique(torch.cat([ring[ring >= 0], over]))
    _boundary(counts, snap, rows, tm.cap, nh, write_snap=False)
    return out, counts


@pytest.mark.parametrize("start", ["init", "trained", "overcap"])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("name", sorted(_MODELS))
def test_cluster_chunks_match_jax_decode_semi(name, chunk, start):
    """The mirror's symbols and final counts == _decode_semi's and the
    plain version's, on a stream K11 -> K7 -> K3 (plain) encoded."""
    jm, tm, g, cg, valid, aux, table = _stream(name)
    T = g.shape[0]
    assert T % chunk == 0 and T // chunk >= 4
    c0 = _start(name, jm, g, valid, aux, table, start)
    tc0 = None if c0 is None else torch.from_numpy(c0)
    gt, cgt = torch.from_numpy(g), torch.from_numpy(cg)
    nh = te._n_halve_chunk(tm, _L, chunk)
    sf, _ = tk.semi_encode_walk(gt, cgt, tm, nh, chunk, tc0)
    words, emit, states = tk.rans_encode_sf(sf, cgt)
    out, n = tk.compact_words(words, emit)
    k = int(n.item())
    wpad = torch.zeros(1 << max(10, (k + 8).bit_length()), dtype=torch.int16)
    wpad[:k] = out[:k]
    syms, counts = _cluster_mirror(states, wpad, cgt, T, tm, nh, chunk, c0)
    jc0 = je.init_counts(jm) if c0 is None else jnp.asarray(c0)
    jsyms, jcounts, _ = je._decode_semi(
        jm, nh, chunk, jc0, jm.lane_init(_L),
        jnp.asarray(states.numpy().view(np.uint32)),
        jnp.asarray(wpad.numpy().view(np.uint16)), valid, aux)
    v = np.asarray(valid)
    assert np.array_equal(syms.numpy()[v], np.asarray(jsyms)[v])
    assert np.array_equal(syms.numpy()[v], g[v])
    assert not syms.numpy()[~v].any()
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    psyms, pcounts = tk.semi_decode(states, wpad, cgt, T, tm, nh, chunk, tc0)
    assert torch.equal(psyms, syms)
    assert np.array_equal(pcounts.numpy(), counts.numpy())


def test_overcap_rows_stay_over_cap_and_rows_go_untouched():
    """The over-cap case does what it is for: at chunk 16 both raised rows
    are still over cap after the first boundary's n_halve halvings (and
    the second's), one of them is never read, and most rows of the table
    are never touched."""
    name, chunk = "fqz_q2", 16
    jm, tm, g, cg, valid, aux, table = _stream(name)
    c0 = _start(name, jm, g, valid, aux, table, "overcap")
    nh = te._n_halve_chunk(tm, _L, chunk)
    rows = torch.from_numpy(c0[(c0.sum(axis=1) > jm.cap)]).long()
    assert len(rows) == 2
    assert (_halve(rows, jm.cap, 2 * nh).sum(dim=1) > jm.cap).all()
    ctx = np.asarray(je._ctx_grids(jm, jnp.asarray(g), aux))[
        np.asarray(valid)]
    used = np.bincount(ctx, minlength=jm.n_ctx) > 0
    assert not used[c0.sum(axis=1) > jm.cap].all()
    assert used.mean() < 0.1


@pytest.mark.parametrize("A", [4, 40, 41, 57])
def test_snapshot_count_search_equals_binary_search(A):
    """On snapshot rows (the port's F[s] | F[s+1] << 16, from counts with
    zero-frequency symbols, a row of zeros but its last count, and an
    all-zero row) the count gives the binary search's symbol, start and
    freq for every slot value low."""
    rng = np.random.default_rng(A)
    counts = rng.integers(0, 50, (6, A)).astype(np.int32)
    counts[0] = 0
    counts[1, ::3] = 0
    counts[2, :-1] = 0
    snap = tk._snapshot(torch.from_numpy(counts))
    lows = torch.arange(RANS_M)
    for row in snap:
        rows = row[None, :].expand(RANS_M, A)
        got = _count_search(rows, lows)
        want = _binary_search(rows, lows)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
