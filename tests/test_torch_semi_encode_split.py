"""The schedule of the redesigned K11 (csrc/semi_encode.cu), on the CPU.

K11 writes every slot's context into a (T, L) grid (-1 at padding) by
the chunk walk (one thread a (chunk of C waves, lane), chunk_walk.cuh),
then runs the decoder's table schedule (semi_table.cuh, the one copy K12
runs): boundary 0 over every row (the snapshot, and the rows the start
leaves over cap); before every later chunk a boundary over the rows of
the last chunk's slice of the context grid (the ring) and the rows the
last boundary left over cap, each once, up to n_halve halvings then the
snapshot; per chunk the slots' gathers from the snapshot and their count
adds; after the last chunk a boundary that only halves.

A plain mirror of that schedule, kept here and never on the card path,
is held to the JAX engine's _pass1_semi (start, freq at the valid slots
and the final counts) and to the port's plain version
(kernels.semi_encode_walk_plain, which the card tests hold the kernel
to): chunks 16 and T, from init, from a trained table and from a start
with rows over cap that the stream reads and that no chunk touches; and
a stream of no waves, which leaves the table as it started.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import kernels as tk
from test_torch_encode_split import _chunk_sf
from test_torch_semi_cluster import _L, _boundary, _start, _stream

_C = 16                        # the chunk walk's waves a thread


@functools.lru_cache(maxsize=None)
def _ctx_grid(name):
    """chunk_ctx on a stream: every slot's context by the chunk walk, -1
    at padding (the walk's sf with the identity table ctx * A + sym)."""
    _, tm, g, cg, _, _, _ = _stream(name)
    A = tm.alphabet
    ident = np.arange(tm.n_ctx * A, dtype=np.int64)
    sf, n = _chunk_sf(g, cg, tm, ident, _C)
    valid = np.arange(g.shape[0])[:, None] < n[None, :]
    return torch.from_numpy(np.where(valid, sf // A, -1))


def _k11_mirror(g, ctxg, tm, nh, chunk, counts0):
    """K11's launches after the context grid ctxg: boundary c for c = 0
    .. T / chunk and the slot pass of chunk c after each but the last."""
    T, L = g.shape
    A = tm.alphabet
    syms = torch.from_numpy(g).long()
    counts = (torch.full((tm.n_ctx, A), tm.init, dtype=torch.int64)
              if counts0 is None else torch.from_numpy(counts0).long())
    snap = torch.zeros_like(counts)
    sf = torch.zeros((T, L), dtype=torch.int64)
    n_chunks = T // chunk
    over = torch.zeros(0, dtype=torch.int64)
    for c in range(n_chunks + 1):
        if c == 0:
            rows = torch.arange(tm.n_ctx)
        else:
            ring = ctxg[(c - 1) * chunk:c * chunk]
            rows = torch.unique(torch.cat([ring[ring >= 0], over]))
        over = _boundary(counts, snap, rows, tm.cap, nh if c else 0,
                         write_snap=c < n_chunks)
        if c == n_chunks:
            break
        cx = ctxg[c * chunk:(c + 1) * chunk]
        sx = syms[c * chunk:(c + 1) * chunk]
        v = cx >= 0
        part = torch.zeros_like(cx)
        part[v] = snap[cx[v], sx[v]]
        sf[c * chunk:(c + 1) * chunk] = part
        counts.index_put_((cx[v], sx[v]),
                          torch.full_like(cx[v], tm.inc), accumulate=True)
    return sf, counts


def _jax_pass1_semi(jm, g, valid, aux, nh, chunk, c0):
    jc0 = je.init_counts(jm) if c0 is None else jnp.asarray(c0)
    ctx = je._ctx_grids(jm, jnp.asarray(g), aux)
    return je._pass1_semi(jm, nh, chunk, jc0, ctx, jnp.asarray(g), valid)


@pytest.mark.parametrize("start", ["init", "trained", "overcap"])
@pytest.mark.parametrize("chunk", [16, "T"])
@pytest.mark.parametrize("name", ["seq_o6", "fqz_q2"])
def test_semi_encode_schedule_matches_jax_pass1_semi(name, chunk, start):
    """The mirror's sf (start | end << 16) and final counts ==
    _pass1_semi's (start, freq) at the valid slots and counts, and the
    plain version's sf (0 at padding) and counts."""
    jm, tm, g, cg, valid, aux, table = _stream(name)
    T = g.shape[0]
    chunk = T if chunk == "T" else chunk
    assert T % chunk == 0
    c0 = _start(name, jm, g, valid, aux, table, start)
    nh = te._n_halve_chunk(tm, _L, chunk)
    sf, counts = _k11_mirror(g, _ctx_grid(name), tm, nh, chunk, c0)
    start_j, freq_j, counts_j = _jax_pass1_semi(jm, g, valid, aux, nh,
                                                chunk, c0)
    v = np.asarray(valid)
    s = sf.numpy()
    assert np.array_equal((s & 0xFFFF)[v], np.asarray(start_j)[v])
    assert np.array_equal(((s >> 16) - (s & 0xFFFF))[v],
                          np.asarray(freq_j)[v])
    assert not s[~v].any()
    assert np.array_equal(counts.numpy(), np.asarray(counts_j))
    psf, pcounts = tk.semi_encode_walk(
        torch.from_numpy(g), torch.from_numpy(cg), tm, nh, chunk,
        None if c0 is None else torch.from_numpy(c0))
    assert np.array_equal(tk._u32(psf).numpy(), s)
    assert np.array_equal(pcounts.numpy(), counts.numpy())


def test_overcap_start_keeps_an_untouched_row_over_cap():
    """The over-cap start does what it is for here: at chunk T, after the
    one boundary that halves (the last), the row no chunk touches is
    still over cap in the JAX counts, so only the over-cap list visits
    it, and most rows are never in a ring."""
    name = "fqz_q2"
    jm, tm, g, cg, valid, aux, table = _stream(name)
    T = g.shape[0]
    c0 = _start(name, jm, g, valid, aux, table, "overcap")
    nh = te._n_halve_chunk(tm, _L, T)
    ctxg = _ctx_grid(name)
    touched = np.zeros(jm.n_ctx, bool)
    touched[ctxg[ctxg >= 0].numpy()] = True
    big = np.flatnonzero(c0.sum(axis=1) > jm.cap)
    assert len(big) == 2 and touched[big].tolist().count(False) == 1
    _, _, counts_j = _jax_pass1_semi(jm, g, valid, aux, nh, T, c0)
    untouched = big[~touched[big]][0]
    assert np.asarray(counts_j)[untouched].sum() > jm.cap
    assert touched.mean() < 0.1


def test_no_waves_leaves_the_table():
    """T = 0: no chunk, so no boundary halves; the table comes back as
    it started (over-cap rows too), as _pass1_semi's scan over no chunks
    returns it."""
    name = "fqz_q2"
    jm, tm, g, cg, valid, aux, table = _stream(name)
    c0 = _start(name, jm, g, valid, aux, table, "overcap")
    g0 = np.zeros((0, _L), np.uint8)
    cg0 = np.zeros((1, _L), np.int32)
    valid0, aux0 = je._device_aux(0, jnp.asarray(cg0))
    nh = te._n_halve_chunk(tm, _L, 16)
    sf, counts = _k11_mirror(g0, torch.zeros((0, _L), dtype=torch.int64),
                             tm, nh, 16, c0)
    _, _, counts_j = _jax_pass1_semi(jm, g0, valid0, aux0, nh, 16, c0)
    assert sf.shape == (0, _L)
    assert np.array_equal(counts.numpy(), c0)
    assert np.array_equal(np.asarray(counts_j), c0)
    psf, pcounts = tk.semi_encode_walk(
        torch.from_numpy(g0), torch.from_numpy(cg0), tm, nh, 16,
        torch.from_numpy(c0))
    assert np.array_equal(pcounts.numpy(), c0)
