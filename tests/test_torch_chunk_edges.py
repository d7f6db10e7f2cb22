"""The cases K13's and K4's designs split on, on the CPU.

K13 (csrc/train_counts.cu) cuts every lane's column into chunks of C
waves, one thread a (chunk, lane), and recovers the lane walk's state at
each chunk start: the read cursor from the read-length grid, the seq
history and quality ranks by looking back in the column, quality's drops
by a scan over the chunks.  K4 (csrc/frozen_decode.cu) spreads the lanes
of a wave over a thread-block cluster, finds each symbol by counting the
row's entries at or below the state's slot instead of a binary search,
and reads renormalization words at a clamped offset.

Each case makes its input with numpy from a seed and requires exact
equality between the JAX engine (fastqueeze_tpu.ops.engine) and the
port's plain versions, which the card tests (tests/test_torch_gpu.py)
hold the kernels to.  Beside them, a scalar mirror of K13's chunk walk
(the kernels' steps, in Python) and of K4's counting search is held to
the same results, so that the decomposition itself is checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.models import base as jb
from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.config import RANS_M, CodecParams
from fastqueeze_tpu_torch.models import base as tb
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import kernels as tk
from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid

_P = dict(lanes_min=1, lanes_max=1 << 16, lane_target_symbols=256)

# every model kind K13 takes: 0 seq, 1 quality (fqz drops min(drops, 56);
# a rank chain with drops >> 3 in 2 bits), 2 order-0, 3 order-1 byte,
# 4 flat (contexts from a grid)
_KINDS = {
    "seq_o10": ("SeqModel", dict(alphabet=4, init=3, inc=1, cap=253,
                                 order=10)),
    "fqz_q2": ("QualModel", dict(alphabet=41, init=1, inc=8, cap=8192,
                                 qlevel=2)),
    "chain_k4_drop2": ("QualModel", dict(alphabet=41, init=1, inc=16,
                                         cap=8192, k=4, ctx_base=41,
                                         hash_bits=12, pos_bits=3,
                                         drop_bits=2)),
    "order0": ("CtxModel", dict(alphabet=256, init=1, inc=16, cap=8192)),
    "order1_byte": ("Order1ByteModel", dict(alphabet=256, init=1, inc=16,
                                            cap=8192)),
    "flat_4": ("FlatModel", dict(alphabet=2, init=1, inc=16, cap=8192,
                                 n_ctx=4)),
}
_CHUNKS = (32, 64, 128)
_L = 8


def _models(name):
    cls, kw = _KINDS[name]
    return getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)


def _lane_reads(rng):
    """Per lane, its reads' lengths in order: chunk-crossing reads at C =
    32, 64 and 128, one read of 480 waves (15 chunks at C = 32), reads
    ending exactly on a chunk boundary followed by zero-length slots (so a
    chunk's first wave follows one), and random lengths with zeros."""
    lanes = [
        [480],
        [31, 2, 40, 63, 65, 1, 127, 129],
        [64, 0, 64, 0, 0, 32, 0, 96, 128, 0, 16],
        [32, 0, 96, 0, 1, 0, 255, 33],
        [0, 0, 130, 0, 257, 0, 70],
        [5] * 40 + [0, 0, 300],
    ]
    while len(lanes) < _L:
        n = rng.integers(2, 6)
        lens = rng.integers(0, 100, n)
        lens[rng.random(n) < 0.3] = 0
        lanes.append(list(lens))
    J = max(len(x) for x in lanes)
    counts = np.zeros(J * _L, np.int64)
    for lane, lens in enumerate(lanes):
        counts[lane:lane + len(lens) * _L:_L] = lens
    return counts


def _symbols(rng, name, tm, counts):
    """Symbols read-major.  Qualities: per read either alternating highs
    and zeros (drops pass 56, and 24 for drops >> 3 in 2 bits, within a
    few symbols, inside one chunk) or a slow descent (drops cross their
    thresholds at scattered waves, carried from chunk to chunk)."""
    n = int(counts.sum())
    if name.startswith(("fqz", "chain")):
        out = []
        for r, c in enumerate(counts[counts > 0]):
            if r % 2:
                q = np.where(np.arange(c) % 2, 0, 40)
            else:
                q = np.clip(40 - np.arange(c) // 9
                            + rng.integers(-1, 2, c), 0, 40)
            out.append(q)
        return np.concatenate(out).astype(np.uint8)
    return rng.integers(0, tm.alphabet, n).astype(np.uint8)


def _case(name, seed=1):
    jm, tm = _models(name)
    rng = np.random.default_rng(seed)
    counts = _lane_reads(rng)
    syms = _symbols(rng, name, tm, counts)
    aux = ({"ctx": rng.integers(0, 4, len(syms)).astype(np.uint8)}
           if name == "flat_4" else None)
    return jm, tm, counts, syms, aux


# --- a scalar mirror of K13's chunk walk ----------------------------------

def _ctx(kind, v, st, pos):
    """lane_walk.cuh model_ctx (kinds 0-3)."""
    if kind in (0, 3):
        return st["h"]
    if kind != 1:
        return 0
    k, base, hb, db, pb, qlevel, _ = v
    q = st["q"]
    if k >= 2:
        c = min(q[0], base - 1)
        for j in range(1, min(k, 8)):
            c = (c * base + min(q[j], base - 1)) & 0xFFFFFFFF
        ctx = ((c * 2654435761) & 0xFFFFFFFF) & ((1 << hb) - 1) if hb else c
        if db:
            ctx = (ctx << db) | min(st["drops"] >> 3, (1 << db) - 1)
        if pb:
            ctx = (ctx << pb) | min(pos >> 4, (1 << pb) - 1)
        return ctx
    q1, q2 = q[0], q[1]
    c = ((max(q1, q2) << 6) + q1) & 0xFFF
    if qlevel >= 2:
        c += 0x1000 if q1 == q2 else 0
        c += (min(st["drops"], 56) & ~7) << 10
    if qlevel >= 3:
        c += min(pos >> 3, 15) << 16
    return c


def _reset(kind, v):
    if kind == 0:
        return {"h": v[1] & v[0]}
    if kind == 1:
        return {"q": [0] * 8, "drops": v[6]}
    return {"h": 0}


def _update(kind, v, st, sym):
    if kind == 0:
        st["h"] = ((st["h"] << 2) | sym) & v[0]
    elif kind == 1:
        st["drops"] += max(st["q"][0] - sym, 0)
        st["q"] = [sym] + st["q"][:7]
    elif kind == 3:
        st["h"] = sym


def _chunked_hist(g, cg, tm, C, ctxg=None):
    """K13's histogram as its kernels compute it: chunk_cursors (the
    cursor at each chunk start), chunk_drops + drops_scan (quality's drops
    at each chunk start), then chunk_hist per (chunk, lane): the state
    from looking back in the column, the walk over C waves."""
    kind, v = tm.spec()
    v = list(v) + [0] * (7 - len(v))
    T, L = g.shape
    J = cg.shape[0]
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
    hist = np.zeros((tm.n_ctx, tm.alphabet), np.int64)
    for c in range(nch):
        for lane in range(L):
            if cur[c, lane, 0] < 0:
                continue
            t0, pos0 = c * C, int(cur[c, lane, 1])
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
            elif pos0 and kind == 3:
                st["h"] = int(g[t0 - 1, lane])

            def start(st=st):
                st.update(_reset(kind, v))

            def slot(t, pos, st=st, lane=lane):
                s = int(g[t, lane])
                ctx = (int(ctxg[t, lane]) if kind == 4
                       else _ctx(kind, v, st, pos))
                hist[ctx, s] += tm.inc
                _update(kind, v, st, s)

            walk(c, lane, slot, start)
    return hist


@pytest.mark.parametrize("name", sorted(_KINDS))
def test_train_counts_chunk_edges_match_jax(name):
    """K13's plain version (whole table and its two halves) == the JAX
    trainer on chunk-crossing, zero-length and long reads; the scalar
    mirror of the chunk walk at C = 32, 64 and 128 == the same
    histogram."""
    jm, tm, counts, syms, aux = _case(name)
    want = np.asarray(je.train_counts(jm, JParams(**_P), syms, counts,
                                      extra_aux=aux, n_lanes=_L))
    got = te.train_counts(tm, CodecParams(**_P), syms, counts,
                          extra_aux=aux, n_lanes=_L, device="cpu")
    assert np.array_equal(got.numpy(), want)
    lay = make_layout(counts, _L)
    assert lay.T <= 512
    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(te._counts_grid(counts, _L))
    ctxg = (None if aux is None
            else torch.from_numpy(to_grid(lay, aux["ctx"].astype(np.int32))))
    hist = tk.train_hist(g, cg, tm, torch.zeros(
        (tm.n_ctx, tm.alphabet), dtype=torch.int32), ctxg)
    assert np.array_equal(tk.train_rows(hist.clone(), tm).numpy(), want)
    for C in _CHUNKS:
        mirror = _chunked_hist(g.numpy(), cg.numpy(), tm, C,
                               None if ctxg is None else ctxg.numpy())
        assert np.array_equal(mirror, hist.numpy().astype(np.int64)), C


def test_drops_saturate_inside_a_chunk_and_carry():
    """The quality cases do what they are for: at C = 32 some chunk starts
    inside a read with drops under 56 and reaches 56 before its end (the
    carried value and the saturation in one chunk), and some chunk starts
    inside a read with drops in 8..55 (a nonzero carry the context still
    reads)."""
    _, tm, counts, syms, _ = _case("fqz_q2")
    lay = make_layout(counts, _L)
    g = to_grid(lay, syms).astype(np.int64)
    cg = te._counts_grid(counts, _L)
    drops = np.full(g.shape, -1, np.int64)   # before each slot's symbol
    pos = np.full(g.shape, -1, np.int64)
    for lane in range(_L):
        t = 0
        for ln in cg[:, lane]:
            d, q0 = tm.drop_init, 0
            for i in range(ln):
                drops[t, lane], pos[t, lane] = d, i
                d += max(q0 - g[t, lane], 0)
                q0 = g[t, lane]
                t += 1
    C = 32
    saturates = carries = False
    for t0 in range(0, lay.T, C):
        for lane in range(_L):
            if pos[t0, lane] <= 0:
                continue
            d0 = drops[t0, lane]
            run = drops[t0:t0 + C, lane]
            same = pos[t0:t0 + C, lane] == pos[t0, lane] + np.arange(len(run))
            saturates |= bool(d0 < 56 and (run[same] >= 56).any())
            carries |= bool(8 <= d0 < 56)
    assert saturates and carries


# --- K4 -------------------------------------------------------------------

_DECODE = {
    "seq_o10": ("SeqModel", dict(alphabet=4, order=10)),
    "fqz_q2": ("QualModel", dict(alphabet=41, qlevel=2)),
}


def _decode_case(name, L, seed):
    cls, kw = _DECODE[name]
    jm, tm = getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 70, 2 * L + 3).astype(np.int64)
    counts[::7] = 0                       # zero-length slots
    syms = rng.integers(0, jm.alphabet, int(counts.sum())).astype(np.uint8)
    top = 254 if jm.alphabet == 4 else 300
    table = rng.integers(1, top, (jm.n_ctx, jm.alphabet)).astype(np.int32)
    return jm, tm, counts, syms, table


@pytest.mark.parametrize("L", [1, 3, 64, 4097])
@pytest.mark.parametrize("name", sorted(_DECODE))
def test_frozen_decode_lane_counts_match_jax(name, L):
    """K4's plain version == the JAX frozen decode at lane counts that are
    not a multiple of a cluster's threads (1, 3, 4097) and a small one;
    lanes end at different waves, zero-length slots between reads."""
    jm, tm, counts, syms, table = _decode_case(name, L, L)
    lens = np.bincount(np.arange(len(counts)) % L, weights=counts,
                       minlength=L)
    assert L < 3 or len(set(lens.astype(int))) > 1
    pay = je.encode_stream(jm, JParams(**_P), syms, counts,
                           counts0=jnp.asarray(table), adapt=False,
                           n_lanes=L)
    want = np.asarray(je.decode_stream(jm, JParams(**_P), pay, counts,
                                       counts0=jnp.asarray(table),
                                       adapt=False))
    got = te.decode_stream(tm, CodecParams(**_P), pay, counts,
                           counts0=te.frozen_table(table, "cpu"),
                           device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(got, syms)


@pytest.mark.parametrize("L", [64, 4097])
def test_frozen_decode_clamps_a_short_payload_as_jax(L):
    """A payload whose word count is cut: renormalization reads past the
    real words hit the clamp words[min(off + rank, W - 1)] of the padded
    buffer; the plain version decodes what the JAX engine decodes."""
    jm, tm, counts, syms, table = _decode_case("seq_o10", L, 11)
    pay = bytearray(je.encode_stream(jm, JParams(**_P), syms, counts,
                                     counts0=jnp.asarray(table),
                                     adapt=False, n_lanes=L))
    n_words = int.from_bytes(pay[8:12], "little")
    pay[8:12] = (n_words // 3).to_bytes(4, "little")
    pay = bytes(pay[:16 + 4 * L + 2 * (n_words // 3)])
    want = np.asarray(je.decode_stream(jm, JParams(**_P), pay, counts,
                                       counts0=jnp.asarray(table),
                                       adapt=False))
    got = te.decode_stream(tm, CodecParams(**_P), pay, counts,
                           counts0=te.frozen_table(table, "cpu"),
                           device="cpu")
    assert np.array_equal(got, want)
    assert not np.array_equal(got, syms)


def _count_search(row, low):
    """K4's search: sym = #{s in 1..A-1 : F[s] <= low}, start the largest
    of F[0] and those entries, end the smallest of F[A] and the entries
    above low (csrc/frozen_decode.cu row_search)."""
    A = len(row) - 1
    mid = row[1:A]
    le = mid <= low
    start = max(int(row[0]), int(mid[le].max()) if le.any() else 0)
    end = min(int(row[A]), int(mid[~le].min()) if (~le).any() else 0xFFFF)
    return int(le.sum()), start, end - start


@pytest.mark.parametrize("A", [4, 41, 57, 96])
def test_count_search_equals_binary_search(A):
    """On quantized rows (K1's, zero-frequency symbols included, and an
    all-zero row) the count gives the binary search's symbol, start and
    freq for every slot value low."""
    rng = np.random.default_rng(A)
    counts = rng.integers(0, 50, (6, A)).astype(np.int32)
    counts[0] = 0
    counts[1, ::3] = 0
    counts[2, :-1] = 0
    cum, _ = tk.quant_pack(torch.from_numpy(counts))
    F = cum.numpy().view(np.uint16).astype(np.int64)
    lows = np.arange(RANS_M)
    for row in F:
        assert (np.diff(row) >= 0).all()
        lo = np.zeros_like(lows)
        hi = np.full_like(lows, A - 1)
        for _ in range(max(1, (A - 1).bit_length())):
            m = (lo + hi + 1) >> 1
            le = row[m] <= lows
            lo, hi = np.where(le, m, lo), np.where(le, hi, m - 1)
        for low in range(0, RANS_M, 97):
            assert _count_search(row, low) == (
                int(lo[low]), int(row[lo[low]]),
                int(row[lo[low] + 1] - row[lo[low]]))
