"""The port's stage spans (utils/metrics.py DebugInfo.span) on the CPU.

A compress and a decompress of a small multi-block single-end file, and
of a paired-end pair, under torch.profiler give every stage of the SE and
the PE path as an ``fq.<stage>`` range on the thread that ran it: each
range lasts what its span added to the DebugInfo, and each child range
lies inside its parent.  With the profiler off no range is entered.  Under ``-t 4`` every block's stages are counted
(no add is lost between the worker threads), and the frozen trainer's
memos count one miss, then one hit.  Every table the trainer's
quality-context selection scores counts once, as ``qctx_host_scores``
under ``--cpu`` and as ``qctx_card_scores`` where the card scores them
(here the card scorer forced on, its kernels' plain versions), each
priced inside ``train.qctx.price``.
"""

import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler as torch_profiler
from torch.profiler import ProfilerActivity, profile

from fastqueeze_tpu_torch import api
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.pipeline import frozen
from fastqueeze_tpu_torch.utils.metrics import SPANNED, DebugInfo

BLOCK = 20_000      # ~12 blocks of the 1,000-read input

COMPRESS = ("read", "train", "train.parse", "train.dedup", "train.hist",
            "train.qctx", "train.qctx.price", "train.ship", "train.stage",
            "probe",
            "selfref_probe", "serialize", "parse", "parse.md5", "dispatch",
            "encode", "md5", "write", "codec.dedup", "codec.vocab",
            "codec.streams", "codec.ids", "codec.plus", "codec.small",
            "codec.wait", "codec.tlv", "native.encode_o1",
            "native.encode_ctx")
DECOMPRESS = ("deserialize", "read", "decode", "codec.host",
              "codec.streams", "codec.wait", "assemble", "md5", "write",
              "native.decode_o1", "native.decode_ctx")
# (child, parent): the child range lies inside a parent range (-t 1)
NESTED = {
    "compress": [(c, "train") for c in COMPRESS if c.startswith("train.")]
    + [("train.qctx.price", "train.qctx"), ("parse.md5", "parse"),
       ("selfref_probe", "probe")]
    + [(c, "dispatch") for c in ("codec.dedup", "codec.vocab",
                                 "codec.streams", "codec.ids", "codec.plus",
                                 "codec.small")]
    + [("codec.wait", "encode"), ("codec.tlv", "encode"),
       ("native.encode_o1", "dispatch"), ("native.encode_ctx", "dispatch")],
    "decompress": [(c, "decode") for c in ("read", "codec.host",
                                           "codec.streams", "codec.wait",
                                           "assemble", "md5", "write")]
    + [("native.decode_o1", "codec.host"),
       ("native.decode_ctx", "codec.host")],
}
# the PE path: compress_pe on the SE loop, with file 2's records read
# inside ``read`` and the mates interleaved for the trainer, the probe and
# each block pair's parse; decode deinterleaves each block pair
PE_COMPRESS = COMPRESS + ("pe.mate2", "pe.interleave")
PE_DECOMPRESS = DECOMPRESS + ("pe.deinterleave",)
PE_NESTED = {
    "compress": NESTED["compress"] + [("pe.mate2", "read"),
                                      ("pe.interleave",
                                       ("train", "probe", "parse"))],
    "decompress": NESTED["decompress"] + [("pe.deinterleave", "decode")],
}


def _fastq(path, n=1000, seed=21):
    """Seeded reads of 60-140 bp from a small random genome, a few N
    bases, one exact duplicate, random-walk qualities, SRA-style IDs."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 200_000)
    bins = np.array([2, 12, 24, 37])
    recs = []
    for r in range(n):
        L = int(rng.integers(60, 141))
        s = int(rng.integers(0, len(genome) - L))
        seq = bytearray(b"ACGT"[c] for c in genome[s:s + L])
        if r % 17 == 0:
            seq[5] = ord("N")
        walk = np.clip(np.cumsum(rng.integers(-1, 2, L)) + 2, 0, 3)
        recs.append(b"@SRR0000021.%d %d length=%d\n" % (r + 1, r + 1, L)
                    + bytes(seq) + b"\n+\n"
                    + bytes((bins[walk] + 33).astype(np.uint8)) + b"\n")
    recs[10] = recs[3]
    with open(path, "wb") as fh:
        fh.write(b"".join(recs))


def _params(**kw):
    # slevel 0: the smallest seq table, so training takes well under 1 s
    return CodecParams(use_model=1, block_bytes=BLOCK, slevel=0, **kw)


def _ranges(trace_path, closed):
    """{name: [(start, end, tid, seconds)]}: the fq.* ranges in us, in the
    order they began, each with the seconds its span added to the
    DebugInfo (``closed``: each name's in the order they ended; a name's
    spans never overlap on one thread, so they end in that order too)."""
    with open(trace_path) as fh:
        tr = json.load(fh)
    out = {}
    for e in tr["traceEvents"] if isinstance(tr, dict) else tr:
        name = e.get("name", "")
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and name.startswith("fq.")):
            out.setdefault(name[3:], []).append(
                (e["ts"], e["ts"] + e["dur"], e.get("tid")))
    for name, rs in out.items():
        assert len(rs) == len(closed[name]), name
        out[name] = [r + (s,) for r, s in zip(sorted(rs), closed[name])]
    return out


def _profiled(d, fq, arc, run):
    """A compress and a decompress of ``fq`` (one path, or a PE pair)
    under torch.profiler, the trainer's memos empty: {phase: (ranges,
    DebugInfo values), "memos": what they hold after}."""
    closed = {}
    close = DebugInfo._close

    def keep(self, name, dt, outer):
        closed.setdefault(name, []).append(dt)
        close(self, name, dt, outer)

    out = {"memos": ({}, {})}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(frozen, "_TRAIN_CACHE", out["memos"][0])
        mp.setattr(frozen, "_DESER_CACHE", out["memos"][1])
        mp.setattr(DebugInfo, "_close", keep)
        for phase in ("compress", "decompress"):
            dbg = DebugInfo()
            closed.clear()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                if phase == "compress":
                    api.compress(fq, arc, params=_params(), device="cpu",
                                 dbg=dbg)
                else:
                    api.decompress(arc, str(d / "back"), device="cpu",
                                   dbg=dbg)
            path = str(d / f"{phase}{run}.json")
            prof.export_chrome_trace(path)
            out[phase] = (_ranges(path, closed), dict(dbg.vals))
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Two profiled runs of a fresh input, and the files for the other
    tests."""
    d = tmp_path_factory.mktemp("torch_trace")
    fq, arc = str(d / "in.fq"), str(d / "in.fqz")
    _fastq(fq)
    return d, fq, arc, [_profiled(d, fq, arc, k) for k in range(2)]


@pytest.fixture(scope="module")
def traced_pe(tmp_path_factory):
    """The same for a pair of mate files (equal IDs, their own lengths)."""
    d = tmp_path_factory.mktemp("torch_trace_pe")
    fq, arc = (str(d / "in_1.fq"), str(d / "in_2.fq")), str(d / "in.fqz")
    for path, seed in zip(fq, (21, 22)):
        _fastq(path, n=600, seed=seed)
    return d, fq, arc, [_profiled(d, fq, arc, k) for k in range(2)]


def _every_stage(traced, phase, want, restored):
    d, fq, _, runs = traced
    ranges, vals = runs[0][phase]
    assert set(want) <= set(ranges), sorted(set(want) - set(ranges))
    if phase == "decompress":
        for path, back in zip([fq] if isinstance(fq, str) else fq,
                              restored):
            with open(path, "rb") as a, open(str(d / "back") + back,
                                             "rb") as b:
                assert a.read() == b.read()
        assert vals["codec.streams_n"] == vals["assemble_n"] > 1


@pytest.mark.parametrize("phase", ("compress", "decompress"))
def test_every_stage_is_a_range(traced, phase):
    _every_stage(traced, phase, COMPRESS if phase == "compress"
                 else DECOMPRESS, (".fastq",))


@pytest.mark.parametrize("phase", ("compress", "decompress"))
def test_every_pe_stage_is_a_range(traced_pe, phase):
    """The SE names, file 2's reads, the interleave and deinterleave, and
    the codec's stages on PE decode."""
    _every_stage(traced_pe, phase, PE_COMPRESS if phase == "compress"
                 else PE_DECOMPRESS, ("_1.fastq", "_2.fastq"))
    ranges, vals = traced_pe[3][0][phase]
    if phase == "compress":
        assert vals["pairs"] == 600 and vals["reads"] == 1200
        pairs = len(ranges["parse"])
        assert vals["pe.mate2_n"] == pairs > 2
        # the trainer's, the probe's (the first pair's, reused: no -l),
        # and each later pair's
        assert vals["pe.interleave_n"] == pairs + 1


@pytest.mark.parametrize("phase", ("compress", "decompress"))
def test_ranges_match_the_table(traced, phase):
    """Each range lasts its span's seconds within 1 ms + 1%, in one of the
    two runs (the same code, the same ranges: a span that times other
    code than its range misses in both, while the scheduler's pause
    between the two clock reads of a busy machine hits one run at a
    time); a name's spans add up to its DebugInfo seconds and count; the
    outermost ranges on the calling thread are what spanned_s adds."""
    _match_table(traced, phase)


@pytest.mark.parametrize("phase", ("compress", "decompress"))
def test_pe_ranges_match_the_table(traced_pe, phase):
    _match_table(traced_pe, phase)


def _match_table(traced, phase):
    (r0, vals), (r1, _) = (run[phase] for run in traced[3])
    assert {n: len(rs) for n, rs in r0.items()} == {
        n: len(rs) for n, rs in r1.items()}
    for name, rs in r0.items():
        for (a, b, _, s), (c, e, _, t) in zip(rs, r1[name]):
            assert (b - a) / 1e6 == pytest.approx(s, rel=0.01, abs=1e-3) \
                or (e - c) / 1e6 == pytest.approx(t, rel=0.01, abs=1e-3), \
                name
        assert sum(s for *_, s in rs) == pytest.approx(vals[name + "_s"])
        if name + "_n" in vals:
            assert vals[name + "_n"] == len(rs), name
    tid = r0["read"][0][2]
    mine = [r for rs in r0.values() for r in rs if r[2] == tid]
    outer = [r for r in mine if not any(
        p[0] <= r[0] and r[1] <= p[1] and p[1] - p[0] > r[1] - r[0]
        for p in mine)]
    assert sum(r[3] for r in outer) == pytest.approx(vals[SPANNED])


def _inside_parents(ranges, nested):
    for child, parents in nested:
        parents = (parents,) if isinstance(parents, str) else parents
        for a, b, tid, _ in ranges[child]:
            assert any(pa <= a and b <= pb and pt == tid
                       for parent in parents
                       for pa, pb, pt, _ in ranges[parent]), (child, parents)


@pytest.mark.parametrize("phase", ("compress", "decompress"))
def test_each_pe_child_lies_inside_its_parent(traced_pe, phase):
    _inside_parents(traced_pe[3][0][phase][0], PE_NESTED[phase])


@pytest.mark.parametrize("phase", ("compress", "decompress"))
def test_each_child_lies_inside_its_parent(traced, phase):
    ranges = traced[3][0][phase][0]
    _inside_parents(ranges, NESTED[phase])
    if phase == "compress":
        # the encode stages of the timers before spans stay disjoint
        legacy = sorted((a, b) for n in ("parse", "dispatch", "encode")
                        for a, b, _, _ in ranges[n])
        assert all(b <= c for (_, b), (c, _) in zip(legacy, legacy[1:]))


def test_no_range_with_the_profiler_off(traced, monkeypatch):
    """A compress (its tables from the memo) and a decompress with the
    profiler off enter no record_function; the memos count a miss on the
    profiled calls and a hit here."""
    d, fq, arc, runs = traced
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch_profiler, "record_function", Counting)
    monkeypatch.setattr(frozen, "_TRAIN_CACHE", runs[1]["memos"][0])
    monkeypatch.setattr(frozen, "_DESER_CACHE", runs[1]["memos"][1])
    assert not torch_profiler._is_profiler_enabled
    dc, dd = DebugInfo(), DebugInfo()
    api.compress(fq, str(d / "again.fqz"), params=_params(), device="cpu",
                 dbg=dc)
    api.decompress(arc, str(d / "again"), device="cpu", dbg=dd)
    assert entered == []
    assert dc.vals["codec.dedup_n"] > 1 and dd.vals["decode_s"] > 0
    first_c, first_d = runs[1]["compress"][1], runs[1]["decompress"][1]
    assert (first_c["train_cache_miss"], first_c.get("train_cache_hit")) \
        == (1, None)
    assert (dc.vals["train_cache_hit"], dc.vals.get("train_cache_miss")) \
        == (1, None)
    assert (first_d["deser_cache_miss"], first_d.get("deser_cache_hit")) \
        == (1, None)
    assert (dd.vals["deser_cache_hit"], dd.vals.get("deser_cache_miss")) \
        == (1, None)
    with open(str(d / "in.fqz"), "rb") as a, \
            open(str(d / "again.fqz"), "rb") as b:
        assert a.read() == b.read()


def test_no_add_is_lost_across_threads(traced):
    """-t 4: two compress calls and two decompress calls into one table
    each; every block's stages are counted (adaptive coder: no
    training)."""
    d, fq, _, _ = traced
    dc, dd = DebugInfo(), DebugInfo()
    for k in range(2):
        r = api.compress(fq, str(d / f"t4_{k}.fqz"),
                         params=CodecParams(block_bytes=BLOCK, threads=4),
                         device="cpu", dbg=dc)
        api.decompress(str(d / f"t4_{k}.fqz"), str(d / f"t4_{k}"),
                       threads=4, device="cpu", dbg=dd)
    n = 2 * r["blocks"]
    assert r["blocks"] > 4
    for stage in ("dedup", "vocab", "streams", "ids", "plus", "wait", "tlv"):
        assert dc.vals[f"codec.{stage}_n"] == n, stage
    assert dc.vals["codec.small_n"] == 2 * n      # lengths; dup + degenerate
    assert dd.vals["codec.streams_n"] == dd.vals["assemble_n"] == n
    assert dd.vals["codec.wait_n"] == 2 * n       # seq, qual
    assert dd.vals["codec.host_n"] == 4 * n
    assert dd.vals["md5_n"] == 2 * n              # the block's, the file's


def test_the_scores_are_counted_on_their_side(traced, monkeypatch):
    """--cpu: each table _select_qctx scores is one qctx_host_scores and
    one train.qctx.price, and no qctx_card_scores; the card scorer (on
    the CPU, its kernels' plain versions) counts the same tables as
    qctx_card_scores instead, and the archive is the same."""
    d, fq, arc, runs = traced
    vals = runs[0]["compress"][1]
    n = vals["qctx_host_scores"]
    assert n == vals["train.qctx.price_n"] > 1
    assert "qctx_card_scores" not in vals
    monkeypatch.setattr(frozen, "_TRAIN_CACHE", {})
    monkeypatch.setattr(frozen, "_scores_on_card", lambda device: True)
    dc = DebugInfo()
    api.compress(fq, str(d / "card.fqz"), params=_params(), device="cpu",
                 dbg=dc)
    assert dc.vals["qctx_card_scores"] == n
    assert dc.vals["train.qctx.price_n"] == n
    assert "qctx_host_scores" not in dc.vals
    with open(arc, "rb") as a, open(str(d / "card.fqz"), "rb") as b:
        assert a.read() == b.read()
