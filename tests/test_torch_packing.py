"""The frozen tables' packing thread (fastqueeze_tpu_torch/pipeline/
frozen.py _Packing) on the CPU.

The port's serialize_frozen, which joins the thread, gives the JAX
package's bytes on trained tables of every encoding (bz2 ``b``, zlib
``z``, bz2 planes ``pb``, zlib planes ``p9``), with the seq table's
winning bucket both mantissa-bucketed and not.  compress_se encodes every
block while the pack still runs, and its archive equals the JAX package's;
an error of the thread surfaces from compress_se and leaves no thread
alive; a second compress of the same file takes the trained tables from
the memo and starts no packing.  The thread's stages add to ``pack_s``,
not to the call's ``spanned_s``.  compress_pe, on the same loop, holds
the pack until its ``serialize``, after the last block pair is
dispatched, writes the JAX package's archive, and raises the pack's
error with no thread left.
"""

import hashlib
import json
import threading
import time

import numpy as np
import pytest

from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.io.fastq import parse_block as jparse
from fastqueeze_tpu.pipeline import driver as jd
from fastqueeze_tpu.pipeline import frozen as jf
from fastqueeze_tpu.pipeline import pe as jpe
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import ArcWriter
from fastqueeze_tpu_torch.container.encap import iter_tlv
from fastqueeze_tpu_torch.io.fastq import parse_block
from fastqueeze_tpu_torch.pipeline import driver as td
from fastqueeze_tpu_torch.pipeline import frozen as tf
from fastqueeze_tpu_torch.pipeline import pe as tpe
from fastqueeze_tpu_torch.utils import metrics
from fastqueeze_tpu_torch.utils.metrics import SPANNED, DebugInfo


def _fastq(n, seed=5, genome_bp=200_000, L=100, qspread=40):
    """Seeded n x L bp reads of a random genome with uniform qualities
    (qspread distinct values)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome_bp)
    st = rng.integers(0, genome_bp - L, n)
    seqs = np.frombuffer(b"ACGT", np.uint8)[g[st[:, None] + np.arange(L)]]
    quals = (rng.integers(0, qspread, (n, L)) + 33).astype(np.uint8)
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(),
                                             quals[i].tobytes())
                    for i in range(n))


# case: (reads, quality values, params, est_total_syms, seq enc, qual enc,
#        the seq table's winner is a mantissa bucket)
_CASES = {
    "seq_b_bucketed_qual_pb": (2000, 6, dict(slevel=0), 0, "b", "pb", True),
    # a projection of 500 x the sample prices the bucket's stream penalty
    # above its blob saving
    "seq_b_unbucketed": (2000, 6, dict(slevel=0), 10 ** 8, "b", "pb",
                         False),
    "seq_pb": (2000, 6, dict(slevel=0, seq_cap=4000, seq_inc=16), 0, "pb",
               "pb", True),
    # a forced rank chain of base 2, k 2: a 4-row quality table, small
    # enough for zlib's smaller header to win
    "qual_z": (2000, 6, dict(slevel=0, qctx_k=2, qctx_base=2, qual_cap=200),
               0, "b", "z", True),
    "qual_p9": (2000, 6, dict(slevel=0, qctx_k=2, qctx_base=2), 0, "b", "p9",
                True),
}


@pytest.fixture
def fresh_memos(monkeypatch):
    monkeypatch.setattr(tf, "_TRAIN_CACHE", {})
    monkeypatch.setattr(jf, "_TRAIN_CACHE", {})


@pytest.mark.parametrize("case", sorted(_CASES))
def test_serialize_matches_jax(case, fresh_memos, monkeypatch):
    n, qs, kw, est, seq_enc, qual_enc, bucketed = _CASES[case]
    raw = _fastq(n, qspread=qs)
    winners = []
    ship = tf._bucket_ship

    def spy(counts, hist, scale):
        out = ship(counts, hist, scale)
        winners.append((counts.shape, out[0] is not counts))
        return out

    monkeypatch.setattr(tf, "_bucket_ship", spy)
    fz = tf.train_frozen(CodecParams(use_model=1, **kw), parse_block(raw),
                         est_total_syms=est)
    blob = tf.serialize_frozen(fz)
    jblob = jf.serialize_frozen(jf.train_frozen(
        JParams(use_model=1, **kw), jparse(raw), est_total_syms=est))
    assert blob == jblob
    meta = json.loads(dict(iter_tlv(blob))[tf._TAG_META])
    assert (meta["seq_enc"], meta["qual_enc"]) == (seq_enc, qual_enc)
    seq_shape = np.shape(fz["seq_counts"])
    assert dict(winners)[seq_shape] is bucketed
    # the same tables packed on the calling thread, by either package
    tables = {k: fz[k] for k in ("qmax", "qvals", "seq_counts",
                                 "qual_counts")}
    assert tf.serialize_frozen(dict(tables)) == blob
    assert jf.serialize_frozen(dict(tables)) == blob


def _packing_threads():
    return [t for t in threading.enumerate() if t.name == "fq-pack"]


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_packing") / "in.fq"
    path.write_bytes(_fastq(1500, seed=9, qspread=8))
    return str(path)


def _params():
    return dict(use_model=1, block_bytes=30_000, slevel=0)


def test_the_pack_ends_after_the_blocks(fq, tmp_path, fresh_memos,
                                        monkeypatch):
    """The pack is held until the call waits for it: every block is
    written before it ends, the archive is the JAX package's, the thread
    has ended when the call returns; the second compress takes the memo's
    tables and packs nothing."""
    release = threading.Event()
    ended, added, started = [], [], []
    pack, result, add = tf._pack_counts, tf._Packing.result, \
        ArcWriter.add_block
    init = tf._Packing.__init__

    def slow_pack(a, level=9, estimate=False, priced=None):
        out = pack(a, level, estimate, priced)
        if not estimate:
            release.wait(20)
            ended.append(time.perf_counter())
        return out

    def joined(self):
        release.set()
        return result(self)

    def adding(self, *a):
        added.append(time.perf_counter())
        return add(self, *a)

    def starting(self):
        started.append(self)
        init(self)

    monkeypatch.setattr(tf, "_pack_counts", slow_pack)
    monkeypatch.setattr(tf._Packing, "result", joined)
    monkeypatch.setattr(tf._Packing, "__init__", starting)
    monkeypatch.setattr(ArcWriter, "add_block", adding)
    out, jout = str(tmp_path / "t.fqz"), str(tmp_path / "j.fqz")
    dbg = DebugInfo()
    r = td.compress_se(CodecParams(**_params()), fq, out, dbg=dbg,
                       device="cpu")
    assert r["blocks"] > 4 and len(added) == r["blocks"]
    assert len(started) == 1 and len(ended) == 2
    assert max(added) < min(ended)
    assert not _packing_threads()
    jd.compress_se(JParams(**_params()), fq, jout)
    with open(out, "rb") as a, open(jout, "rb") as b:
        digest = hashlib.sha256(a.read()).digest()
        assert digest == hashlib.sha256(b.read()).digest()

    again, dbg2 = str(tmp_path / "again.fqz"), DebugInfo()
    td.compress_se(CodecParams(**_params()), fq, again, dbg=dbg2,
                   device="cpu")
    assert len(started) == 1 and dbg2.vals["train_cache_hit"] == 1
    assert "pack_s" not in dbg2.vals and not _packing_threads()
    with open(again, "rb") as a:
        assert hashlib.sha256(a.read()).digest() == digest


def test_an_error_of_the_pack_surfaces(fq, tmp_path, fresh_memos,
                                       monkeypatch):
    """A pack that raises makes compress_se raise it, leaves no thread,
    and is not memoized: the next compress trains again and succeeds."""
    pack = tf._pack_counts

    def failing(a, level=9, estimate=False, priced=None):
        if not estimate:
            raise RuntimeError("pack failed")
        return pack(a, level, estimate, priced)

    monkeypatch.setattr(tf, "_pack_counts", failing)
    with pytest.raises(RuntimeError, match="pack failed"):
        td.compress_se(CodecParams(**_params()), fq,
                       str(tmp_path / "x.fqz"), device="cpu")
    assert not _packing_threads() and not tf._TRAIN_CACHE
    monkeypatch.setattr(tf, "_pack_counts", pack)
    dbg = DebugInfo()
    td.compress_se(CodecParams(**_params()), fq, str(tmp_path / "y.fqz"),
                   dbg=dbg, device="cpu")
    assert dbg.vals["train_cache_miss"] == 1


def test_the_pack_spans_stay_off_the_call(fq, tmp_path, fresh_memos,
                                          monkeypatch):
    """pack, pack.seq and pack.qual are timed on the packing thread into
    the call's table, and spanned_s (the calling thread's outermost
    spans) leaves them out: it stays within the call's wall time, which
    it would pass with the pack's overlapping seconds added."""
    pack = tf._pack_counts
    threads = set()

    def slow_pack(a, level=9, estimate=False, priced=None):
        if not estimate:
            threads.add(threading.get_ident())
            time.sleep(0.25)
        return pack(a, level, estimate, priced)

    monkeypatch.setattr(tf, "_pack_counts", slow_pack)
    dbg = DebugInfo()
    t0 = time.perf_counter()
    td.compress_se(CodecParams(**_params()), fq, str(tmp_path / "s.fqz"),
                   dbg=dbg, device="cpu")
    wall = time.perf_counter() - t0
    v = dbg.vals
    assert (v["pack_n"], v["pack.seq_n"], v["pack.qual_n"]) == (2, 1, 1)
    assert v["pack_s"] == pytest.approx(v["pack.seq_s"] + v["pack.qual_s"],
                                        abs=1e-3)
    assert min(v["pack.seq_s"], v["pack.qual_s"]) > 0.25
    assert len(threads) == 1 and threading.get_ident() not in threads
    assert v[SPANNED] <= wall < v[SPANNED] + v["pack_s"]
    assert v["serialize_s"] < v["pack_s"]


@pytest.fixture(scope="module")
def fq_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_packing_pe")
    paths = (str(d / "in_1.fq"), str(d / "in_2.fq"))
    for path, seed in zip(paths, (9, 10)):
        with open(path, "wb") as fh:
            fh.write(_fastq(1500, seed=seed, qspread=8))
    return paths


def test_the_pe_pack_ends_after_the_pairs(fq_pair, tmp_path, fresh_memos,
                                          monkeypatch):
    """compress_pe: the pack is held until the call waits for it, which
    it does once, inside its ``serialize``, after every block pair is
    dispatched; the archive is the JAX package's and no thread is left."""
    release = threading.Event()
    ended, dispatched, waits = [], [], []
    pack, result, job = tf._pack_counts, tf._Packing.result, \
        td.encode_block_job

    def slow_pack(a, level=9, estimate=False, priced=None):
        out = pack(a, level, estimate, priced)
        if not estimate:
            release.wait(20)
            ended.append(time.perf_counter())
        return out

    def joined(self):
        waits.append([s.name for s in metrics._stack()])
        release.set()
        return result(self)

    def dispatching(*a, **kw):
        fin = job(*a, **kw)
        dispatched.append(time.perf_counter())
        return fin

    monkeypatch.setattr(tf, "_pack_counts", slow_pack)
    monkeypatch.setattr(tf._Packing, "result", joined)
    monkeypatch.setattr(td, "encode_block_job", dispatching)
    out, jout = str(tmp_path / "t.fqz"), str(tmp_path / "j.fqz")
    dbg = DebugInfo()
    r = tpe.compress_pe(CodecParams(**_params()), *fq_pair, out, dbg=dbg,
                        device="cpu")
    assert r["blocks"] > 3 and len(dispatched) == r["blocks"]
    assert len(ended) == 2 and max(dispatched) < min(ended)
    assert waits == [["serialize"]]
    assert dbg.vals["serialize_n"] == 1 and dbg.vals["pack_n"] == 2
    assert not _packing_threads()
    jpe.compress_pe(JParams(**_params()), *fq_pair, jout)
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()


def test_an_error_of_the_pe_pack_surfaces(fq_pair, tmp_path, fresh_memos,
                                          monkeypatch):
    """A pack that raises makes compress_pe raise it and leaves no
    thread; nothing is memoized."""
    pack = tf._pack_counts

    def failing(a, level=9, estimate=False, priced=None):
        if not estimate:
            raise RuntimeError("pack failed")
        return pack(a, level, estimate, priced)

    monkeypatch.setattr(tf, "_pack_counts", failing)
    with pytest.raises(RuntimeError, match="pack failed"):
        tpe.compress_pe(CodecParams(**_params()), *fq_pair,
                        str(tmp_path / "x.fqz"), device="cpu")
    assert not _packing_threads() and not tf._TRAIN_CACHE
