"""The row pass (csrc/train_counts.cu rows_finalize) on the CPU.

The row pass is K13's row half, with the mesh trainer's reduce over
'block' folded into it: it sums nb partial tables of the same rows, adds
init, then halves ((c + 1) >> 1) every row whose total is over cap, at
most 24 times, a row's counts held in registers over a group of lanes.
Here the plain versions (ops/kernels.py train_rows, train_rows_sum),
which the card tests hold the kernel to, are held to the JAX row formula
on tables whose edge rows take every branch: a row that needs all 24
halvings, a total at cap, one over, zero rows.  A mirror of the kernel's
lane layout (its instantiations, in Python) is held to the same results,
so that each layout is seen to cover every entry of a row once.  Every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu_torch.models.base import QualModel, SeqModel
from fastqueeze_tpu_torch.ops import kernels


def _jax_rows(raw: np.ndarray, init: int, cap: int) -> np.ndarray:
    """The JAX trainers' row formula after the histogram
    (fastqueeze_tpu/ops/engine.py _train_counts, parallel/mesh.py
    train_counts_sharded's local_train): + init, then 24 rounds that halve
    the rows whose int32 total is over cap."""
    counts = jnp.asarray(raw, jnp.int32) + init
    for _ in range(24):
        tot = counts.sum(axis=1, keepdims=True)
        counts = jnp.where(tot > cap, (counts + 1) >> 1, counts)
    return np.asarray(counts)


def _rounds(row: np.ndarray, init: int, cap: int) -> int:
    """The halvings a raw row takes (int64 totals)."""
    c, k = row.astype(np.int64) + init, 0
    while k < 24 and c.sum() > cap:
        c, k = (c + 1) >> 1, k + 1
    return k


# (A, cap): the alphabets the kernel specialises.  Under cap 256 a row
# that needs all 24 halvings has an int32 total (over cap x 2^23), so the
# JAX formula's int32 sum holds it; at cap 8192 the deepest row whose
# total stays in int32 takes 19.
_TABLES = [(4, 253), (41, 250), (48, 250), (41, 8192), (48, 8192)]


def _model(A: int, cap: int):
    if A == 4:
        return SeqModel(alphabet=4, init=3, inc=1, cap=cap, order=3)
    return QualModel(alphabet=A, init=1, inc=8, cap=cap, qlevel=1)


def _edge_table(m, seed: int, n: int = 96) -> np.ndarray:
    """n random raw rows with the edge rows at the first and last four:
    zeros, a total of cap after init, one over, and the deepest row whose
    total after init stays in int32."""
    A, init, cap = m.alphabet, m.init, m.cap
    raw = np.random.default_rng(seed).integers(0, 600, (n, A))
    at = np.zeros(A, np.int64)
    at[0] = cap - A * init
    deep = np.full(A, min(-(-(cap << 23) // A) + 1,
                          ((1 << 31) - 1) // A) - init, np.int64)
    one = np.eye(A, dtype=np.int64)[0]
    edges = np.stack([np.zeros(A, np.int64), at, at + one, deep])
    raw[:4], raw[-4:] = edges, edges
    return raw.astype(np.int32)


@pytest.mark.parametrize("A,cap", _TABLES)
def test_row_pass_edge_rows_match_jax(A, cap):
    """train_rows (in place) and train_rows_sum over 1, 2 and 4 partials
    that sum to the table == the JAX row formula; the edge rows take the
    branches they are for."""
    m = _model(A, cap)
    raw = _edge_table(m, seed=A + cap)
    want = _jax_rows(raw, m.init, m.cap)
    rounds = [_rounds(r, m.init, m.cap) for r in raw[:4]]
    assert rounds[:3] == [0, 0, 1]
    assert rounds[3] == (24 if cap < 256 else 19)
    assert want[1].sum() == cap and want[2].sum() <= cap
    got = torch.from_numpy(raw.copy())
    assert kernels.train_rows(got, m) is got
    np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(cap)
    for nb in (1, 2, 4):
        # partials that sum to raw: raw cut at nb - 1 random fractions
        fr = np.sort(rng.random((nb - 1,) + raw.shape), axis=0)
        cut = np.concatenate([np.zeros((1,) + raw.shape, np.int64),
                              np.floor(fr * raw).astype(np.int64),
                              raw[None].astype(np.int64)])
        parts = [torch.from_numpy(d.astype(np.int32))
                 for d in np.diff(cut, axis=0)]
        assert sum(p.long() for p in parts).tolist() == raw.tolist()
        for fn in (kernels.train_rows_sum, kernels.train_rows_sum_plain):
            np.testing.assert_array_equal(fn(parts, m).numpy(), want)


# csrc/train_counts.cu run_rows: (lanes a row G, int32 a piece V, pieces
# a lane P) by alphabet, for rows 16-byte aligned or not
def _layout(A: int, aligned: bool = True):
    vec = aligned and A % 4 == 0
    if A == 4 and vec:
        return 1, 4, 1
    if A in (40, 48) and vec:
        return 4, 4, 3
    if A == 41:
        return 8, 1, 6
    if A <= 16:
        return 1, 1, 16
    if A <= 64:
        return 8, 1, 8
    return 32, 1, 8


def _mirror(parts, A: int, init: int, cap: int, aligned: bool = True):
    """rows_finalize in Python: lane j of a row's group holds pieces j,
    j + G, ... (V entries each, P registers of pieces); every register
    gets init and the halvings, the group total sums the lanes' valid
    pieces (the shuffle reduction), at most 24 rounds."""
    G, V, P = _layout(A, aligned)
    pieces = A // V
    n = parts[0].shape[0]
    out = np.zeros((n, A), np.int64)
    for r in range(n):
        regs = np.zeros((G, P * V), np.int64)
        for j in range(G):
            for k in range(P):
                q = j + k * G
                if q < pieces:
                    for p in parts:
                        regs[j, k * V:(k + 1) * V] += p[r, q * V:(q + 1) * V]
        regs += init
        valid = np.array([[j + k * G < pieces for k in range(P)
                           for _ in range(V)] for j in range(G)])

        def total():
            return int(sum(regs[j][valid[j]].sum() for j in range(G)))

        C, h = total(), 0
        while h < 24 and C > cap:
            regs = (regs + 1) >> 1
            C, h = total(), h + 1
        for j in range(G):
            for k in range(P):
                q = j + k * G
                if q < pieces:
                    out[r, q * V:(q + 1) * V] = regs[j, k * V:(k + 1) * V]
    return out


@pytest.mark.parametrize("A,aligned", [
    (1, True), (2, True), (4, True), (4, False), (8, True), (16, True),
    (17, True), (40, True), (40, False), (41, True), (48, True),
    (64, True), (65, True), (256, True)])
def test_row_pass_layout_covers_each_entry_once(A, aligned):
    """Each layout the kernel launches holds every entry of a row in
    exactly one lane's registers, and its rounds on the registers give
    the plain version's table from two partials."""
    G, V, P = _layout(A, aligned)
    assert A % V == 0 and G * P * V >= A and G in (1, 2, 4, 8, 16, 32)
    held = sorted(q * V + i for j in range(G) for k in range(P)
                  for q in [j + k * G] if q < A // V for i in range(V))
    assert held == list(range(A))
    m = QualModel(alphabet=A, init=1, inc=8, cap=40 * A, qlevel=1)
    rng = np.random.default_rng(A)
    parts = [rng.integers(0, 200, (12, A)).astype(np.int32) for _ in range(2)]
    parts[0][0] = 1 << 24
    want = kernels.train_rows_sum_plain([torch.from_numpy(p) for p in parts],
                                        m).numpy()
    np.testing.assert_array_equal(_mirror(parts, A, m.init, m.cap, aligned),
                                  want)
