"""The frozen trainer's card scorer (fastqueeze_tpu_torch/pipeline/frozen.py
_CardScorer) on the CPU: its kernels' plain versions against the host
scorer, which is today's _select_qctx, and against the JAX package's
trainer.

K20's plain version (ops/kernels.py hist_nll_plain: the terms of the
code length, summed by np.sum here) against the port's and the JAX
package's _hist_nll_bits on tables of u8, u16 and int32,
mantissa-bucketed or not, an empty histogram among them; K13's row half with inc (train_rows,
train_rows_sum) against frozen._cap_rescale; narrow_rows against
_narrow_np.  Then whole trainings, the card scorer forced on with
``device="cpu"`` (so K13, K20 and narrow_rows run as their plain
versions): on seeded single-end and interleaved paired-end prefixes,
a binned 8-value quality case, with the holdout off and with a forced
scheme, both scorers choose the same scheme and alpha, price and score
the same tables to the same float, count their scores, and the MODEL
sections are equal; and the card scorer's MODEL section and chosen
qctx_* fields equal those of the JAX package's train_frozen +
serialize_frozen on the same reads.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fqbench import gen  # noqa: E402

from fastqueeze_tpu.config import CodecParams as JParams  # noqa: E402
from fastqueeze_tpu.io.fastq import parse_block as jparse  # noqa: E402
from fastqueeze_tpu.pipeline import frozen as jf  # noqa: E402
from fastqueeze_tpu.pipeline.pe import \
    interleave_blocks as jinterleave  # noqa: E402
from fastqueeze_tpu_torch.config import CodecParams  # noqa: E402
from fastqueeze_tpu_torch.io.fastq import parse_block  # noqa: E402
from fastqueeze_tpu_torch.models.base import QualModel  # noqa: E402
from fastqueeze_tpu_torch.ops import kernels  # noqa: E402
from fastqueeze_tpu_torch.pipeline import frozen  # noqa: E402
from fastqueeze_tpu_torch.pipeline.pe import interleave_blocks  # noqa: E402
from fastqueeze_tpu_torch.utils.metrics import DebugInfo  # noqa: E402

# the benchmark's generator at 12 quality values (the cells' 40 make the
# tables the plain versions build and bz2 prices 3x as wide;
# tests/test_torch_gpu.py takes 40)
READS = dict(kind="se", length=100, genome_bp=200_000, sub_rate=0.01,
             n_rate=0.001, qual_states=12, ids="sra")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them from stalling on busy cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(rng, dtype, shape, hi):
    c = rng.integers(0, hi, shape).astype(dtype)
    return c, torch.from_numpy(c.view(np.int16) if dtype == np.uint16
                               else c)


def _card_sum(t, hist, mbits):
    tab = frozen._log2_table(int(kernels._table_u64(t).sum(1).max()) + 1
                             if t.numel() else 1, "cpu")
    terms, stat = kernels.hist_nll(t, torch.from_numpy(hist), tab, mbits,
                                   hist.size)
    n, top = stat.tolist()
    assert top < tab.shape[0]
    return float(np.sum(terms[:n].numpy()))


@pytest.mark.parametrize("dtype, A, hi", [(np.uint8, 4, 254),
                                          (np.uint16, 40, 9000),
                                          (np.int32, 41, 1 << 17)])
@pytest.mark.parametrize("mbits", [0, 3, 2])
def test_nll_plain_is_the_host_cost(dtype, A, hi, mbits):
    """np.sum of K20's plain terms == _hist_nll_bits of the (bucketed)
    table, the port's and the JAX package's, bit for bit; zero counts
    (an infinite cost where the histogram has the cell) and empty
    histogram rows included."""
    rng = np.random.default_rng(A + mbits)
    c, t = _table(rng, dtype, (700, A), hi)
    c[3, :2] = 0
    t = torch.from_numpy(c.view(np.int16) if dtype == np.uint16 else c)
    h = rng.integers(0, 4, (700, A)).astype(np.int32)
    h[h == 1] = 0
    h[10:20] = 0
    want_t = c if mbits == 0 else frozen._mant_bucket(c, mbits).astype(
        c.dtype)
    got = _card_sum(t, h, mbits)
    assert got == frozen._hist_nll_bits(want_t, h)
    assert got == jf._hist_nll_bits(want_t, h)


def test_nll_of_an_empty_histogram_is_zero():
    rng = np.random.default_rng(5)
    c, t = _table(rng, np.uint16, (64, 8), 100)
    h = np.zeros((64, 8), np.int32)
    terms, stat = kernels.hist_nll(
        t, torch.from_numpy(h), frozen._log2_table(1024, "cpu"), 0, 1)
    assert stat.tolist()[0] == 0
    assert float(np.sum(terms[:0].numpy())) == frozen._hist_nll_bits(c, h)
    assert frozen._hist_nll_bits(c, h) == 0.0
    assert jf._hist_nll_bits(c, h) == 0.0


def test_nll_reports_a_total_past_its_table():
    """A row total past the log2 table is reported, and _card_nll reads
    the cost from a longer table."""
    rng = np.random.default_rng(6)
    c, t = _table(rng, np.uint16, (50, 40), 9000)
    h = rng.integers(0, 3, (50, 40)).astype(np.int32)
    short = frozen._log2_table(16, "cpu")
    _, stat = kernels.hist_nll(t, torch.from_numpy(h), short, 0, h.size)
    top = int(c.astype(np.int64).sum(1).max())
    assert stat.tolist()[1] == top and top >= short.shape[0]
    assert frozen._card_nll(t, torch.from_numpy(h), h.size) \
        == frozen._hist_nll_bits(c, h)


@pytest.mark.parametrize("inc, init, cap", [(8, 1, 8192), (16, 1, 8192),
                                            (24, 1, 8192), (1, 2, 253)])
def test_rows_with_inc_are_cap_rescale(inc, init, cap):
    """K13's row half weighing raw counts by inc (in place and over two
    partials) == _cap_rescale, whose native pass the host scorer runs;
    24 halvings, rows at and one over cap among them."""
    rng = np.random.default_rng(inc)
    model = QualModel(alphabet=40, init=init, inc=inc, cap=cap)
    h = rng.integers(0, 3000, (300, 40)).astype(np.int32)
    h[0] = 0
    h[1] = (1 << 31) // (inc * 40 * 2)
    h[2, :] = 0
    h[2, 0] = max(0, (cap - 40 * init) // inc)
    h[3, :] = 0
    h[3, 0] = (cap - 40 * init) // inc + 1
    want = frozen._cap_rescale(model, h.copy())
    got = kernels.train_rows(torch.from_numpy(h.copy()), model, inc)
    assert np.array_equal(got.numpy(), want)
    lo = h // 3
    got = kernels.train_rows_sum([torch.from_numpy(lo),
                                  torch.from_numpy(h - lo)], model, inc)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("cap, step", [(253, 1), (8192, 1), (8192, 8),
                                       (1 << 17, 1), (1 << 17, 8)])
def test_narrow_rows_is_narrow_np(cap, step):
    rng = np.random.default_rng(cap + step)
    c = rng.integers(0, 1 << 17, (37, 41)).astype(np.int32)
    got = kernels.narrow_rows(torch.from_numpy(c), frozen._narrow_width(cap),
                              step)
    got = frozen._host_table(got)
    want = frozen._narrow_np(c, cap)[::step]
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _se_block(n, seed, **reads):
    """(the reads' bytes, their block)."""
    raw = gen.make_files(seed, n, dict(READS, **reads))[0].tobytes()
    return raw, parse_block(raw, True)


def _markov3_block(n, seed, L=100, A=8):
    """The generator's reads with binned 8-value qualities of order-3
    structure (the next rank a mix of the previous three, 10% noise), on
    which a rank chain beats the fqzcomp formula (tests/test_qctx.py
    _markov3_fastq, vectorized)."""
    rng = np.random.default_rng(seed)
    raw = gen.make_files(seed, n, READS)[0]
    r = [rng.integers(0, A, n) for _ in range(3)]
    q = np.empty((n, L), np.uint8)
    for i in range(L):
        v = (r[-1] * 3 + r[-2] * 2 + r[-3] * 5) % A
        noise = rng.random(n) >= 0.9
        v[noise] = rng.integers(0, A, int(noise.sum()))
        q[:, i] = v
        r = r[1:] + [v]
    recs = np.frombuffer(raw.tobytes(), np.uint8).copy()
    nl = np.flatnonzero(recs == ord("\n"))
    starts = nl[2::4] + 1                     # each record's quality line
    recs[starts[:, None] + np.arange(L)] = 33 + 2 * q
    return recs.tobytes(), parse_block(recs.tobytes(), True)


def _pe_block(n, seed):
    """((mate 1 bytes, mate 2 bytes), the interleaved block)."""
    r1, r2 = gen.make_files(seed, n, dict(READS, kind="pe", insert_min=150,
                                          insert_max=300))
    raw = (r1.tobytes(), r2.tobytes())
    return raw, interleave_blocks(parse_block(raw[0], True),
                                  parse_block(raw[1], True))


def _train(monkeypatch, block, card, est, **kw):
    """One training with the card or the host scorer: (MODEL section,
    the chosen qctx_* fields, the scores' costs in order, the DebugInfo
    values)."""
    costs = []
    cls = frozen._CardScorer if card else frozen._HostScorer
    score = cls.score

    def kept(self, model, hists):
        out = score(self, model, hists)
        costs.append(out[0])
        return out

    p = CodecParams(use_model=1, slevel=0, **kw)
    dbg = DebugInfo()
    with monkeypatch.context() as mp:
        mp.setattr(frozen, "_TRAIN_CACHE", {})
        mp.setattr(cls, "score", kept)
        mp.setattr(frozen, "_scores_on_card", lambda device: card)
        with dbg.span("train"):
            fz = frozen.train_frozen(p, block, est_total_syms=est,
                                     device="cpu")
            blob = frozen.serialize_frozen(fz)
    return (blob, {f: getattr(p, f) for f in frozen._QCTX_FIELDS}, costs,
            dict(dbg.vals))


@pytest.fixture(scope="module")
def raws():
    """(the reads' bytes, their block) by name; PE's bytes are a pair."""
    return {"se": _se_block(600, 11),
            "pe": _pe_block(300, 12),
            "binned": _markov3_block(600, 13)}


@pytest.fixture(scope="module")
def blocks(raws):
    return {k: v[1] for k, v in raws.items()}


# (block, est_total_syms, CodecParams fields, _BIG_TABLE): the holdout is
# on where the estimate is over 1.1 x the sample (60,000 symbols); tables
# past _BIG_TABLE entries are priced by every 8th row
CASES = {
    "se_holdout": ("se", 1 << 20, {}, frozen._BIG_TABLE),
    "pe_holdout": ("pe", 1 << 20, {}, frozen._BIG_TABLE),
    "binned_holdout": ("binned", 1 << 20, {}, frozen._BIG_TABLE),
    "binned_in_sample": ("binned", 0, {}, frozen._BIG_TABLE),
    "binned_big_tables": ("binned", 1 << 20, {}, 1 << 14),
    "forced_scheme": ("se", 1 << 20, dict(qctx_k=2, qctx_drop_bits=3,
                                          qctx_pos_bits=3, qctx_hash_bits=0,
                                          qctx_init=1, qctx_inc=16),
                      frozen._BIG_TABLE),
}


@pytest.fixture(scope="module")
def card_runs():
    """The card scorer's training of each case, once for both tests."""
    return {}


def _card_run(case, blocks, card_runs, monkeypatch):
    name, est, kw, _ = CASES[case]
    if case not in card_runs:
        card_runs[case] = _train(monkeypatch, blocks[name], True, est, **kw)
    return card_runs[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_card_scorer_is_the_host_scorer(case, blocks, card_runs,
                                        monkeypatch):
    name, est, kw, big = CASES[case]
    monkeypatch.setattr(frozen, "_BIG_TABLE", big)
    host = _train(monkeypatch, blocks[name], False, est, **kw)
    card = _card_run(case, blocks, card_runs, monkeypatch)
    assert card[1] == host[1]
    assert card[2] == host[2] and len(host[2]) >= 1
    assert card[0] == host[0]
    n = len(host[2])
    assert host[3]["qctx_host_scores"] == n and "qctx_card_scores" \
        not in host[3]
    assert card[3]["qctx_card_scores"] == n and "qctx_host_scores" \
        not in card[3]
    for d in (host[3], card[3]):
        assert d["train.qctx.price_n"] == n
    if case == "forced_scheme":
        assert (host[1]["qctx_k"], host[1]["qctx_pos_bits"]) == (2, 3)
    if case.startswith("binned"):           # a rank chain wins the ladder
        assert host[1]["qctx_k"] >= 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_card_scorer_is_the_jax_trainer(case, raws, blocks, card_runs,
                                        monkeypatch):
    """The card scorer (its kernels' plain versions) against the JAX
    package's train_frozen + serialize_frozen on the same reads and
    params: the same qctx_* fields and the same MODEL section."""
    name, est, kw, big = CASES[case]
    monkeypatch.setattr(frozen, "_BIG_TABLE", big)
    monkeypatch.setattr(jf, "_BIG_TABLE", big)
    monkeypatch.setattr(jf, "_TRAIN_CACHE", {})
    raw = raws[name][0]
    card = _card_run(case, blocks, card_runs, monkeypatch)
    jblock = (jinterleave(jparse(raw[0], True), jparse(raw[1], True))
              if name == "pe" else jparse(raw, True))
    jp = JParams(use_model=1, slevel=0, **kw)
    jblob = jf.serialize_frozen(jf.train_frozen(jp, jblock,
                                                est_total_syms=est))
    assert card[1] == {f: getattr(jp, f) for f in frozen._QCTX_FIELDS}
    assert card[0] == jblob
    assert card[3]["qctx_card_scores"] == len(card[2])


def test_card_grids_give_the_native_histograms(blocks):
    """The card scorer's two lane grids (K13's plain histogram) == the
    native trainer's full and odd-half histograms of every scheme."""
    from fastqueeze_tpu_torch.io import native
    b = blocks["se"]
    qvals, lut = frozen.qual_vocab(b.qual_flat)
    A = frozen._qual_alphabet(len(qvals) - 1)
    qmodel = QualModel(alphabet=A)
    qsyms = lut[b.qual_flat]
    sc = frozen._CardScorer(CodecParams(), qmodel, np.zeros((1, A)),
                            lambda: qsyms, b.lengths, True, 1.0, 2.0,
                            "cpu")
    for k, db, pb, hb in [(0, 0, 0, 0)] + frozen._qctx_candidates(
            len(qvals))[:4]:
        m = QualModel(alphabet=A, k=k, ctx_base=len(qvals), drop_bits=db,
                      pos_bits=pb, hash_bits=hb)
        full, odd = native.qctx_hist(
            b.qual_flat, b.lengths, 1, lut, A, k, m.ctx_base or 1, db, pb,
            m.drop_init, hash_bits=hb, qlevel=m.qlevel, n_ctx=m.n_ctx,
            holdout=True)
        hA = sc._hist(m, sc.grids[:1]).numpy()
        hB = sc._hist(m, sc.grids[1:]).numpy()
        assert np.array_equal(hB, odd) and np.array_equal(hA + hB, full)
