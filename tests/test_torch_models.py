"""fastqueeze_tpu_torch context models against fastqueeze_tpu's.

The same seeded grids go through the JAX model and its PyTorch port:
``context_grids`` (the encoder's vectorized contexts) and the per-wave
``context``/``update`` lane walk (the decoder's), compared exactly on
every valid slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.models import base as jb
from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu.ops.lanes import make_layout, to_grid
from fastqueeze_tpu_torch.models import base as tb
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import kernels as tk

_CASES = {
    "seq_o4": dict(cls="SeqModel", alphabet=4, order=4),
    "seq_o10": dict(cls="SeqModel", alphabet=4, order=10),
    "fqz_q1": dict(cls="QualModel", alphabet=40, qlevel=1),
    "fqz_q2": dict(cls="QualModel", alphabet=40, qlevel=2),
    "fqz_q3": dict(cls="QualModel", alphabet=40, qlevel=3),
    "k2": dict(cls="QualModel", alphabet=8, k=2, ctx_base=8),
    "k2_drop_pos": dict(cls="QualModel", alphabet=8, k=2, ctx_base=6,
                        drop_bits=3, pos_bits=3),
    "k4": dict(cls="QualModel", alphabet=8, k=4, ctx_base=7),
    "k4_hash_drop_pos": dict(cls="QualModel", alphabet=16, k=4,
                             ctx_base=12, hash_bits=14, drop_bits=2,
                             pos_bits=2),
    # 40^6 > 2^32: the chain wraps the u32 ring before the hash
    "k6_wrap": dict(cls="QualModel", alphabet=40, k=6, ctx_base=40,
                    hash_bits=16),
}


def _models(spec):
    kw = {k: v for k, v in spec.items() if k != "cls"}
    return getattr(jb, spec["cls"])(**kw), getattr(tb, spec["cls"])(**kw)


def _grids(rng, A, L=8, R=40, maxlen=50):
    counts = rng.integers(0, maxlen, R).astype(np.int64)
    counts[::7] = 0                       # zero-length reads
    lay = make_layout(counts, L)
    syms = rng.integers(0, A, int(counts.sum())).astype(np.uint8)
    return counts, lay, to_grid(lay, syms), je._counts_grid(counts, L)


def _aux_both(lay, cg):
    valid, aux = je._device_aux(lay.T, jnp.asarray(cg))
    tvalid, taux = tk.device_aux_plain(lay.T, torch.from_numpy(cg))
    assert np.array_equal(np.asarray(valid), tvalid.numpy())
    for k in ("start", "pos"):
        assert np.array_equal(np.asarray(aux[k]), taux[k].numpy()), k
    return np.array(valid), aux, taux


@pytest.mark.parametrize("case", sorted(_CASES))
def test_context_grids_match(case):
    jm, tm = _models(_CASES[case])
    rng = np.random.default_rng(len(case))
    _, lay, g, cg = _grids(rng, jm.alphabet)
    valid, aux, taux = _aux_both(lay, cg)
    want = np.asarray(jm.context_grids(jnp.asarray(g), aux))
    got = tm.context_grids(torch.from_numpy(g), taux).numpy()
    assert np.array_equal(got[valid], want[valid])
    assert got[valid].max() < tm.n_ctx


@pytest.mark.parametrize("case", sorted(_CASES))
def test_lane_walk_matches(case):
    """JAX walk == torch walk == torch context_grids, wave by wave."""
    jm, tm = _models(_CASES[case])
    rng = np.random.default_rng(100 + len(case))
    _, lay, g, cg = _grids(rng, jm.alphabet, R=24, maxlen=30)
    valid, aux, taux = _aux_both(lay, cg)
    grid_ctx = tm.context_grids(torch.from_numpy(g), taux).numpy()
    jst = jm.lane_init(lay.L)
    tst = tm.lane_init(lay.L, "cpu")
    for t in range(lay.T):
        v = valid[t]
        ja = {k: aux[k][t] for k in aux}
        ta = {k: taux[k][t] for k in taux}
        jc = np.asarray(jm.context(jst, ja))
        tc = tm.context(tst, ta).numpy()
        assert np.array_equal(jc[v], tc[v]), t
        assert np.array_equal(tc[v], grid_ctx[t][v]), t
        sym = g[t]
        jn = jm.update(jst, jnp.asarray(sym), ja)
        jst = {k: jnp.where(jnp.asarray(v), jn[k], jst[k]) for k in jst}
        tn = tm.update(tst, torch.from_numpy(sym), ta)
        tst = {k: torch.where(torch.from_numpy(v), tn[k], tst[k])
               for k in tst}


@pytest.mark.parametrize("case", ["seq_o10", "fqz_q2"])
def test_positions_exact_past_65535(case):
    """One read longer than 65,536 bases: pos must not wrap (the seq
    context would restart, the qual drops baseline would shift)."""
    jm, tm = _models(_CASES[case])
    rng = np.random.default_rng(5)
    counts = np.array([30, 70_000, 20, 45], np.int64)
    lay = make_layout(counts, 2)
    g = to_grid(lay, rng.integers(0, jm.alphabet, int(counts.sum())
                                  ).astype(np.uint8))
    cg = je._counts_grid(counts, 2)
    valid, aux, taux = _aux_both(lay, cg)
    assert int(taux["pos"].max()) == 69_999
    want = np.asarray(jm.context_grids(jnp.asarray(g), aux))
    got = tm.context_grids(torch.from_numpy(g), taux).numpy()
    assert np.array_equal(got[valid], want[valid])


def test_spec_matches_native_walker_order():
    """spec() is the (kind, ints) both the kernels and native take."""
    _, seq = _models(_CASES["seq_o10"])
    assert seq.spec() == (0, ((1 << 20) - 1, 0x007616C7 & ((1 << 20) - 1)))
    _, q = _models(_CASES["k4_hash_drop_pos"])
    assert q.spec() == (1, (4, 12, 14, 2, 2, 2, 5))
    assert te.resolve_device("cpu") == torch.device("cpu")
