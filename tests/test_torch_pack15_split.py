"""The decomposition of the redesigned K17 (csrc/transfer_pack.cu pack15), on
the CPU.

K17 reads the decoded (T, L) grid twice.  A histogram pass: a block per
tile of waves x lane quads (4 lanes, one 32-bit word of a wave), each
thread counting the valid slots (t < its lanes' lengths) of its quad
into its warp's shared sub-histogram, one global add per bin per block.
A write pass: its prologue ranks the 64 symbols,
rank(a) = #{b : h[b] > h[a] or (h[b] = h[a] and b < a)}, which gives the
top 15 in lax.top_k's order and each symbol's nibble; a tile of threads,
each a run of consecutive 4-slot groups in scan order, writes the
nibbles of lut[filled] (filled = the symbol where valid, else top[0])
and ranks its exceptions with a block scan; the tile's offset among all
exceptions comes from a decoupled look-back over per-tile descriptors
(flag, the tile's count, its inclusive prefix) in the order the tiles
took their tickets, a window of 32 descriptors at a time (a warp);
exceptions below cap go to side[16 + rank], and the last tile writes
the count.

A plain mirror of that schedule, kept here and never on the card path,
at small tiles and windows so that a small grid spans many tiles and
windows, is held to the JAX engine's _pack15_dev and to the port's plain
version (kernels.pack15_plain, which the card tests hold the kernel to);
the rank rule to lax.top_k on histograms with ties, zero counts and
fewer than 15 symbols present; the look-back's offsets, under random
schedules of the tiles' steps, to jnp.cumsum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.ops import kernels as tk

_EXC = 15
_JAX_PACK15 = jax.jit(je._pack15_dev)     # as the JAX decode runs it
_AGG, _PRE = 1, 2           # descriptor flags: the tile's count, its prefix


def _ranks(hist):
    """pack15_write's prologue: rank(a) over the 64 counts."""
    h = np.asarray(hist, np.int64)
    b = np.arange(64)
    return np.array([int(((h > h[a]) | ((h == h[a]) & (b < a))).sum())
                     for a in range(64)])


def _hist_mirror(g, lens, waves, quads):
    """pack15_hist: per tile of ``waves`` waves x ``quads`` lane quads, the
    counts of its valid slots below 64, added to the total once a bin."""
    T, L = g.shape
    hist = np.zeros(64, np.int64)
    valid = np.arange(T)[:, None] < lens[None, :]
    for t0 in range(0, T, waves):
        for l0 in range(0, L, 4 * quads):
            tile = g[t0:t0 + waves, l0:l0 + 4 * quads]
            keep = valid[t0:t0 + waves, l0:l0 + 4 * quads] & (tile < 64)
            hist += np.bincount(tile[keep], minlength=64)
    return hist


def _look_back_run(aggs, window, rng):
    """The write pass's tiles as concurrent steps under a random schedule:
    a tile starts (takes its ticket) in ticket order while at most a few
    run; a running tile publishes its count, then looks back a window at
    a time (waiting while a descriptor in the window is unpublished: its
    lanes spin), then publishes its inclusive prefix.  Returns each tile's
    exclusive offset."""
    tiles = len(aggs)
    desc = [(0, 0, 0)] * tiles          # (flag, count, inclusive prefix)
    state = {}                          # running tile -> (base, partial)
    excl = [None] * tiles
    started = 0
    while started < tiles or state:
        if started < tiles and (not state or rng.random() < 0.5):
            desc[started] = ((_PRE, aggs[0], aggs[0]) if started == 0
                             else (_AGG, aggs[started], 0))
            if started == 0:
                excl[0] = 0
            else:
                state[started] = (started - 1, 0)
            started += 1
            continue
        tile = list(state)[rng.integers(len(state))]
        base, part = state[tile]
        win = [desc[j] if j >= 0 else (_PRE, 0, 0)
               for j in range(base, base - window, -1)]
        if any(d[0] == 0 for d in win):
            continue                    # a lane still spins
        stop = next((i for i, d in enumerate(win) if d[0] == _PRE), None)
        if stop is None:
            state[tile] = (base - window, part + sum(d[1] for d in win))
            continue
        done = part + sum(d[1] for d in win[:stop]) + win[stop][2]
        excl[tile] = done
        desc[tile] = (_PRE, aggs[tile], done + aggs[tile])
        del state[tile]
    return excl


def _pack15_mirror(g, lens, rng, threads=4, groups=2, window=4,
                   hist_tile=(3, 2)):
    """K17 at a small tile (``threads`` x ``groups`` 4-slot groups) and
    look-back window: (nibbles (T, L/2), side, n_exc, histogram)."""
    T, L = g.shape
    n = T * L
    cap = n // 4
    hist = _hist_mirror(g, lens, *hist_tile)
    r = _ranks(hist)
    lut = np.where(r < _EXC, r, _EXC)
    top0 = int(np.flatnonzero(r == 0)[0])
    side = np.zeros(16 + cap, np.uint8)
    for a in np.flatnonzero(r < _EXC):
        side[r[a]] = a
    valid = np.arange(T)[:, None] < lens[None, :]
    filled = np.where(valid, g, top0).reshape(-1)
    nib = lut[np.minimum(filled, 63)]
    tile_slots = 4 * threads * groups
    tiles = max(1, -(-n // tile_slots))
    exc = [filled[k * tile_slots:(k + 1) * tile_slots][
        nib[k * tile_slots:(k + 1) * tile_slots] == _EXC]
        for k in range(tiles)]
    # a tile's exceptions in scan order: each thread's groups are
    # consecutive, so the block scan of the threads' counts ranks them
    for k in range(tiles):
        per = [int((nib[s:s + 4 * groups] == _EXC).sum())
               for s in range(k * tile_slots, (k + 1) * tile_slots,
                              4 * groups)]
        assert sum(per) == len(exc[k])
    excl = _look_back_run([len(e) for e in exc], window, rng)
    for k in range(tiles):
        for i, v in enumerate(exc[k]):
            if excl[k] + i < cap:
                side[16 + excl[k] + i] = v
    n_exc = excl[-1] + len(exc[-1])
    nib = nib.reshape(T, L)
    return ((nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(np.uint8), side,
            n_exc, hist)


def _grid(case, rng):
    """(T, L) uint8 grid and (J, L) int32 read lengths of a case."""
    T, L = {"L12": (37, 12), "L20": (29, 20), "ragged": (23, 36),
            "padding_only": (17, 16), "over_cap": (41, 24),
            "ties": (18, 20)}[case]
    J = 3
    if case == "ties":          # 20 symbols of exactly 18 slots each
        g = rng.permutation(np.repeat(np.arange(20) * 2, 18)).reshape(T, L)
    elif case == "over_cap":    # flat over 48 symbols: the sidecar overflows
        g = rng.integers(0, 48, (T, L))
    else:                       # a few hot symbols, the rest rare
        g = rng.integers(0, 48, (T, L))
        hot = rng.random((T, L)) < 0.85
        g[hot] = rng.permutation(48)[rng.integers(0, 3, int(hot.sum()))]
    lens = rng.integers(0, T // J + 1, (J, L))
    if case == "padding_only":
        lens[:] = 0
    elif case == "ties":
        lens[:] = T                 # every slot valid: one read a lane
        lens[1:] = 0
    return g.astype(np.uint8), lens.astype(np.int32)


@pytest.mark.parametrize("case", ["L12", "L20", "ragged", "padding_only",
                                  "over_cap", "ties"])
def test_pack15_mirror_matches_jax(case):
    """The mirror's nibbles, sidecar and count == _pack15_dev's and the
    plain version's; its histogram == the valid slots' counts."""
    rng = np.random.default_rng(len(case))
    g, cg = _grid(case, rng)
    T, L = g.shape
    lens = cg.sum(axis=0)
    assert (T * L) % 32, "the grid should end inside a tile"
    nib, side, n_exc, hist = _pack15_mirror(g, lens, rng)
    valid = np.arange(T)[:, None] < lens[None, :]
    jnib, jside, jn = _JAX_PACK15(jnp.asarray(g), jnp.asarray(valid))
    assert np.array_equal(nib, np.asarray(jnib))
    assert np.array_equal(side, np.asarray(jside))
    assert n_exc == int(jn)
    assert np.array_equal(hist, np.bincount(g[valid], minlength=64))
    pnib, pside, pn = tk.pack15_plain(torch.from_numpy(g),
                                      torch.from_numpy(cg))
    assert np.array_equal(pnib.numpy(), nib)
    assert np.array_equal(pside.numpy(), side)
    assert int(pn.item()) == n_exc
    cap = T * L // 4
    if case == "over_cap":
        assert n_exc > cap
    if case == "padding_only":
        assert n_exc == 0 and not nib.any()
        assert list(side[:16]) == list(range(15)) + [0]
    if case == "ties":
        assert list(side[:15]) == [2 * a for a in range(15)]


def test_rank_rule_matches_lax_top_k():
    """rank(a) < 15 picks lax.top_k's 15 in its order on histograms with
    ties (small counts), zero counts, fewer than 15 symbols present, all
    zeros and one symbol."""
    rng = np.random.default_rng(5)
    hists = [np.zeros(64, np.int64), np.eye(64, dtype=np.int64)[37] * 9]
    for k in range(120):
        h = rng.integers(0, 4, 64)
        h[rng.random(64) < rng.random()] = 0
        if k % 3 == 0:              # fewer than 15 symbols present
            h[rng.permutation(64)[:rng.integers(50, 64)]] = 0
        hists.append(h)
    for h in hists:
        r = _ranks(h)
        assert sorted(r) == list(range(64))
        top = np.argsort(r)[:_EXC]
        want = np.asarray(lax.top_k(jnp.asarray(h, jnp.int32), _EXC)[1])
        assert np.array_equal(top, want), h


@pytest.mark.parametrize("window", [32, 256, 4, 1])
def test_look_back_offsets_match_cumsum(window):
    """Every tile's exclusive offset == jnp.cumsum of the counts before
    it, whatever the order the tiles' steps run in, at windows 32 (the
    kernel's warp), 256, 4 and 1; tiles with no exceptions included."""
    rng = np.random.default_rng(window)
    for tiles in (1, 2, 5, 33, 100, 600):
        aggs = rng.integers(0, 9, tiles)
        aggs[rng.random(tiles) < 0.3] = 0
        want = np.asarray(jnp.cumsum(jnp.asarray(aggs))) - aggs
        for _ in range(3):
            assert list(_look_back_run(list(aggs), window, rng)) == list(
                want)
