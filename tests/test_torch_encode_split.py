"""The decomposition of the redesigned K2 (csrc/frozen_encode.cu), on the CPU.

K2 runs two passes.  Forward: one thread a (chunk of C waves, lane); the
lane walk's state is recovered at the chunk's start (the read cursor
from the read-length grid, the seq history and quality ranks by looking
back in the lane's column, quality's drops by a scan over the chunks:
chunk_walk.cuh, as K13 and K5 walk), then every wave of the chunk inside
the lane gathers its packed table word F[s] | F[s+1] << 16 into sf[t, l]
and the waves past the lane's end get 0.  Reverse: one thread a lane
runs the rANS chain from wave T - 1 down, its sf values staged into a
ring of kRevStages stages of kRevWaves waves, kRevStages - 1 stages ahead,
and each slot's freq divided by a high multiply with the reciprocal the
forward pass wrote beside it and one correction (lane_walk.cuh
rans_encode_lane, recip32, div_by).

A plain mirror of each schedule, kept here and never on the card path, is
held to the JAX engine (_pass1_frozen on the JAX context grids, _pass2)
and to the port's plain version (kernels.frozen_encode_lanes_plain), which
the card tests (tests/test_torch_gpu.py) hold the kernel to.  Inputs come
from numpy with a seed: reads that cross chunks, zero-length slots, lanes
shorter than T (one empty), 300-base reads, T not a multiple of 64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.models import base as jb
from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.models import base as tb
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import kernels as tk
from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid
from test_torch_chunk_edges import _ctx, _reset, _update

_L = 9
# csrc/lane_walk.cuh: the reverse pass's ring
_REV_WAVES, _REV_STAGES = 24, 3
# seq; fqz qualities at qlevel 2 and 3 (alphabet 12 keeps qlevel 3's 2^20
# rows small); the hashed rank chain with drop and pos bits
_MODELS = {
    "seq_o10": ("SeqModel", dict(alphabet=4, order=10)),
    "fqz_q2": ("QualModel", dict(alphabet=41, qlevel=2)),
    "fqz_q3": ("QualModel", dict(alphabet=12, qlevel=3)),
    "chain_k4": ("QualModel", dict(alphabet=41, k=4, ctx_base=41,
                                   hash_bits=12, pos_bits=3, drop_bits=2)),
}


def _case(name, seed=3):
    """(JAX model, port model, (T, L) symbol grid, (J, L) read lengths,
    (n_ctx, A) table).  Lanes hold 300-base reads, reads crossing chunk
    edges at C = 16, 32 and 64, zero-length slots (after a read that ends
    on a chunk edge too), one lane with no reads and short lanes; T = 608
    (t_pad 8), not a multiple of 64."""
    cls, kw = _MODELS[name]
    jm, tm = getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)
    rng = np.random.default_rng(seed)
    lanes = [
        [300, 300],
        [15, 2, 17, 31, 33, 1, 63, 65, 0, 129],
        [64, 0, 64, 0, 0, 32, 0, 96, 128, 0, 16],
        [],
        [0, 0, 300, 0, 17],
        [5] * 30 + [0, 0, 300],
        [1, 0, 1],
        [300, 0, 0, 307],
    ]
    while len(lanes) < _L:
        lens = rng.integers(0, 120, 5)
        lens[rng.random(5) < 0.3] = 0
        lanes.append(list(lens))
    J = max(len(x) for x in lanes)
    counts = np.zeros(J * _L, np.int64)
    for lane, lens in enumerate(lanes):
        counts[lane:lane + len(lens) * _L:_L] = lens
    n = int(counts.sum())
    if cls == "QualModel":       # drops cross their thresholds mid-read
        syms = np.clip(np.cumsum(rng.integers(-3, 3, n)) % 60 - 10, 0,
                       jm.alphabet - 1)
    else:
        syms = rng.integers(0, jm.alphabet, n)
    lay = make_layout(counts, _L, t_pad=8)
    assert lay.T == 608
    g = to_grid(lay, syms.astype(np.uint8))
    cg = te._counts_grid(counts, _L)
    table = rng.integers(0, 300, (jm.n_ctx, jm.alphabet)).astype(np.int32)
    table[::5, 1] = 0                       # zero-frequency symbols
    return jm, tm, g, cg, table


def _packed(table):
    return tk.quant_pack_plain(torch.from_numpy(table))[1].numpy().view(
        np.uint32).astype(np.int64)


# --- the forward pass, chunk by chunk -------------------------------------

def _chunk_sf(g, cg, tm, packed, C):
    """K2's forward pass as its kernels compute it: the cursor at each
    chunk start (chunk_cursors), quality's drops at each chunk start
    (chunk_drops + drops_scan), then per (chunk, lane) the state looked
    back for in the column and the walk over the chunk's waves:
    sf = packed[ctx * A + sym], 0 past the lane's end."""
    kind, v = tm.spec()
    v = list(v) + [0] * (7 - len(v))
    T, L = g.shape
    J = cg.shape[0]
    A = tm.alphabet
    nch = -(-T // C)
    cur = np.full((nch, L, 2), -1, np.int64)
    n = np.zeros(L, np.int64)
    for lane in range(L):
        c = t = 0
        for j in range(J):
            ln = int(cg[j, lane])
            while c < nch and c * C < t + ln:
                cur[c, lane] = (j, c * C - t)
                c += 1
            t += ln
        n[lane] = min(t, T)

    def walk(c, lane, on_slot, on_start):
        j, pos = (int(x) for x in cur[c, lane])
        rem = int(cg[j, lane]) - pos
        for t in range(c * C, min(c * C + C, n[lane])):
            if rem == 0:                      # cursor_next
                j += 1
                while j < J and cg[j, lane] == 0:
                    j += 1
                rem, pos = int(cg[j, lane]), 0
                on_start()
            on_slot(t, pos)
            rem -= 1
            pos += 1

    drops_in = np.zeros((nch, L), np.int64)
    if kind == 1:
        for lane in range(L):
            carry = 0
            for c in range(nch):
                if cur[c, lane, 0] < 0:
                    break
                pos0 = int(cur[c, lane, 1])
                rec = {"acc": v[6] if pos0 == 0 else 0, "flag": pos0 == 0,
                       "q0": int(g[c * C - 1, lane]) if pos0 else 0}

                def start():
                    rec.update(acc=v[6], flag=True, q0=0)

                def slot(t, pos):
                    s = int(g[t, lane])
                    rec["acc"] += max(rec["q0"] - s, 0)
                    rec["q0"] = s

                walk(c, lane, slot, start)
                drops_in[c, lane] = carry
                carry = rec["acc"] if rec["flag"] else carry + rec["acc"]
    sf = np.full((T, L), -1, np.int64)
    for c in range(nch):
        for lane in range(L):
            t0 = c * C
            if cur[c, lane, 0] >= 0:
                pos0 = int(cur[c, lane, 1])
                st = _reset(kind, v)
                if pos0 and kind == 0:
                    D = 0
                    while D < 32 and (v[0] >> (2 * D)) != 0:
                        D += 1
                    if pos0 >= D:
                        st["h"] = 0
                    for i in range(min(pos0, D), 0, -1):
                        _update(kind, v, st, int(g[t0 - i, lane]))
                elif pos0 and kind == 1:
                    st["q"] = [int(g[t0 - 1 - j, lane]) if j < pos0 else 0
                               for j in range(8)]
                    st["drops"] = int(drops_in[c, lane])

                def start(st=st):
                    st.update(_reset(kind, v))

                def slot(t, pos, st=st, lane=lane):
                    s = int(g[t, lane])
                    sf[t, lane] = packed[_ctx(kind, v, st, pos) * A + s]
                    _update(kind, v, st, s)

                walk(c, lane, slot, start)
            for t in range(max(t0, n[lane]), min(t0 + C, T)):
                sf[t, lane] = 0
    assert (sf >= 0).all()                  # every slot written once
    return sf, n


@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("name", sorted(_MODELS))
def test_forward_chunks_match_jax_pass1_frozen(name, C):
    """The forward mirror at chunk C == _pass1_frozen's (start, freq) on
    the JAX context grids at every valid slot, 0 at padding."""
    jm, tm, g, cg, table = _case(name)
    packed = _packed(table)
    sf, n = _chunk_sf(g, cg, tm, packed, C)
    T = g.shape[0]
    valid, aux = je._device_aux(T, jnp.asarray(cg))
    ctx = je._ctx_grids(jm, jnp.asarray(g), aux)
    start, freq = je._pass1_frozen(jm.alphabet, jnp.asarray(table), ctx,
                                   jnp.asarray(g))
    v = np.asarray(valid)
    assert np.array_equal(v, np.arange(T)[:, None] < n[None, :])
    assert np.array_equal((sf & 0xFFFF)[v], np.asarray(start)[v])
    assert np.array_equal(((sf >> 16) - (sf & 0xFFFF))[v],
                          np.asarray(freq)[v])
    assert not sf[~v].any()


# --- the reverse pass, staged ----------------------------------------------

def _recip32(d):
    """lane_walk.cuh recip32: floor(2^32 / d), 2^32 - 1 for d = 1."""
    d = np.asarray(d, np.uint64)
    q = np.uint64(0xFFFFFFFF) // d
    return np.where(d == 1, q, q + ((np.uint64(0xFFFFFFFF) - q * d)
                                    == d - np.uint64(1)))


def _div_by(x, d, rcp):
    """lane_walk.cuh div_by: (x / d, x % d) from the high half of x * rcp
    and one correction."""
    x, d = np.asarray(x, np.uint64), np.asarray(d, np.uint64)
    q = (x * rcp) >> np.uint64(32)
    r = x - q * d
    fix = r >= d
    return q + fix, np.where(fix, r - d, r)


def test_reciprocal_division_is_exact():
    """div_by with recip32 == x // d and x % d for every d in 1..2^14 at x
    = 0, 2^16 (the initial state), the emit edges d << 18 and (d << 18) -
    1, (d << 18) - 1 >> 16, 2^32 - 1, and at 10^5 seeded (x, d) pairs."""
    d = np.arange(1, (1 << 14) + 1, dtype=np.uint64)
    rcp = _recip32(d)
    top = (d << np.uint64(18)) - np.uint64(1)
    for x in (np.zeros_like(d), np.full_like(d, 1 << 16), top, top + 1,
              top >> np.uint64(16), np.full_like(d, 0xFFFFFFFF)):
        q, r = _div_by(x, d, rcp)
        assert np.array_equal(q, x // d) and np.array_equal(r, x % d)
    rng = np.random.default_rng(12)
    x = rng.integers(0, 1 << 32, 100_000, dtype=np.uint64)
    dd = rng.integers(1, (1 << 14) + 1, 100_000).astype(np.uint64)
    q, r = _div_by(x, dd, _recip32(dd))
    assert np.array_equal(q, x // dd) and np.array_equal(r, x % dd)

def _reverse(sf, n):
    """rans_encode_lane for all lanes at once: stage k (waves T - 1 - k W
    down to T - (k + 1) W, those inside the lane) copied into ring slot k
    % S while stage k - S + 1 is consumed; the chain from the top wave
    down (the division by div_by), padding waves writing 0 and 0."""
    T, L = sf.shape
    W, S = _REV_WAVES, _REV_STAGES
    nst = -(-T // W)
    ring = np.full((S, W, L), -1, np.int64)

    def stage(k):
        if k < nst:
            for i in range(W):
                t = T - 1 - k * W - i
                if t >= 0:
                    ring[k % S, i] = np.where(t < n, sf[t], -1)

    for k in range(S - 1):
        stage(k)
    x = np.full(L, 1 << 16, np.int64)
    words = np.full((T, L), -1, np.int64)
    emit = np.full((T, L), -1, np.int64)
    for k in range(nst):
        stage(k + S - 1)
        for i in range(W):
            t = T - 1 - k * W - i
            if t < 0:
                break
            live = t < n
            v = ring[k % S, i]
            assert (v[live] >= 0).all()
            start = v & 0xFFFF
            f = (v >> 16) - start
            e = live & ((x >> 18) >= f)
            words[t] = np.where(live, x & 0xFFFF, 0)
            emit[t] = e
            xs = np.where(e, x >> 16, x)
            fs = np.where(live, np.maximum(f, 1), 1)
            q, r = _div_by(xs, fs, _recip32(fs))
            x = np.where(live, (q.astype(np.int64) << 14)
                         + r.astype(np.int64) + start, x)
    assert (words >= 0).all() and (emit >= 0).all()
    return words, emit.astype(bool), x


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_reverse_stages_match_jax_pass2_and_plain(name):
    """The staged reverse mirror over the forward mirror's sf == _pass2's
    emit flags, emitted words and final states, and == the port's plain
    version's words (0 at padding), emit and states, all slots."""
    jm, tm, g, cg, table = _case(name, seed=4)
    packed = _packed(table)
    sf, n = _chunk_sf(g, cg, tm, packed, 64)
    words, emit, x = _reverse(sf, n)
    T = g.shape[0]
    valid = np.arange(T)[:, None] < n[None, :]
    start = np.where(valid, sf & 0xFFFF, 0)
    freq = np.where(valid, (sf >> 16) - (sf & 0xFFFF), 1)
    jw, je_, jx = je._pass2(jnp.asarray(start, jnp.uint16),
                            jnp.asarray(freq, jnp.uint16),
                            jnp.asarray(valid))
    je_ = np.asarray(je_)
    assert np.array_equal(emit, je_)
    assert np.array_equal(words[je_], np.asarray(jw)[je_])
    assert np.array_equal(x, np.asarray(jx))
    pw, pe, px = tk.frozen_encode_lanes(
        torch.from_numpy(g), torch.from_numpy(cg),
        torch.from_numpy(packed.astype(np.uint32).view(np.int32)), tm)
    assert np.array_equal(words, pw.numpy().view(np.uint16))
    assert np.array_equal(emit, pe.numpy().astype(bool))
    assert np.array_equal(x, px.numpy().view(np.uint32))
