"""fastqueeze_tpu_torch's paired-end path against fastqueeze_tpu.

Kernel level: the plain version of K10 (window_batch, the PE mate-rescue
window) against the JAX package's _window_batch and the native host
mirror fq_window_batch on a seeded reference, and Aligner.rescue_mates
against the JAX package's on both routes.  Pipeline level: PE archives
written by the port on the CPU (reference-free adaptive, frozen, variable
lengths with N bases and a file 2 without its final newline, -S self-ref,
and against a reference at defaults, with -I and with -q -I) must equal
the JAX package's byte for byte, and each package decodes the other's;
decompress -P writes what the JAX package writes.  The outputs are
integers and bytes, so every comparison is exact (tolerance 0).
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.align import hash as jh
from fastqueeze_tpu.align import index as jidx
from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.io import fastq as jfq
from fastqueeze_tpu.pipeline import driver as jd
from fastqueeze_tpu.pipeline import pe as jpe
from fastqueeze_tpu_torch.align import hash as th
from fastqueeze_tpu_torch.align import index as tidx
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import FLAG_PE, ArcReader
from fastqueeze_tpu_torch.container.encap import iter_tlv
from fastqueeze_tpu_torch.io import fastq as tfq
from fastqueeze_tpu_torch.io import native
from fastqueeze_tpu_torch.ops import kernels
from fastqueeze_tpu_torch.pipeline import blockcodec
from fastqueeze_tpu_torch.pipeline import driver as td
from fastqueeze_tpu_torch.pipeline import pe as tpe
from fastqueeze_tpu_torch.utils.metrics import DebugInfo

_BASES = np.frombuffer(b"ACGT", np.uint8)
_SEEDLESS = np.arange(7, 100, 14)       # 7 substitutions: no 14-mer survives


# --- K10 and the mate rescue ------------------------------------------------

@pytest.fixture(scope="module")
def window_ref():
    """A seeded 64 kbp reference with a reverse-complement palindrome
    (a forward/RC tie) at 30,000, and both packages' aligners over it."""
    rng = np.random.default_rng(17)
    ref = rng.integers(0, 4, 64_000).astype(np.uint8)
    x = ref[30_000:30_064].copy()
    ref[30_064:30_128] = (3 - x)[::-1]
    refseq = tidx.RefSeq(ref, np.zeros(len(ref), bool), ["r"],
                         np.array([0, len(ref)]), "")
    jref = jidx.RefSeq(ref, np.zeros(len(ref), bool), ["r"],
                       np.array([0, len(ref)]), "")
    tal = th.Aligner(tidx.build_from_ref(refseq, CodecParams()),
                     CodecParams())
    jal = jh.Aligner(jidx.build_from_ref(jref, JParams()), JParams())
    return ref, tal, jal


def _window_reads(rng, ref, lp, C):
    """64 reads with window centers: seedless mates on both strands,
    clean and lightly mutated reads, reads with an N, centers within C/2
    of either end of the reference, random (unmappable) reads, reads
    whose true position lies outside the window, and a forward/RC tie."""
    G = len(ref)
    reads, centers = [], []
    for i in range(64):
        kind = i % 8
        L = int(rng.integers(lp // 2 + 1, lp + 1))
        s = int(rng.integers(C, G - C - L))
        if kind == 3:
            s = int(rng.integers(0, 20))
        elif kind == 4:
            s = G - L - int(rng.integers(0, 20))
        elif kind == 7:
            s, L = 30_000, 128 if lp == 128 else lp
            s = 30_064 - L // 2
        r = ref[s:s + L].copy()
        if kind in (0, 1, 3, 4):
            at = _SEEDLESS[_SEEDLESS < L][:7 if lp > 32 else 2]
            r[at] = (r[at] + rng.integers(1, 4, len(at))) % 4
        elif kind == 2:
            e = rng.random(L) < 0.02
            r[e] = (r[e] + 1) % 4
        elif kind == 5:
            r = rng.integers(0, 4, L).astype(np.uint8)
        elif kind == 7:
            r[L // 3] = (r[L // 3] + 1) % 4
        if kind in (1, 4) or (kind == 2 and i % 16 == 2):
            r = (3 - r)[::-1].copy()
        d = int(rng.integers(-(C // 2) + 2, C // 2 - 2))
        if kind == 6:
            d = C if i % 16 == 6 else -C - L
        centers.append(s + d)
        reads.append(r)
    lengths = np.array([len(r) for r in reads], np.int64)
    codes = np.concatenate(reads)
    dege = np.zeros(len(codes), bool)
    dege[int(lengths[:9].sum()) + 4] = True        # read 9 carries an N
    dege[int(lengths[:18].sum()) + 1] = True       # read 18 too
    return codes, dege, lengths, np.array(centers, np.int32)


@pytest.mark.parametrize("max_insr", [30, 500])
@pytest.mark.parametrize("lp", [32, 64, 128])
def test_window_batch_plain_matches_jax_and_native(window_ref, lp, max_insr):
    ref, tal, jal = window_ref
    C = min(4096, 2 * max_insr + 128)
    rng = np.random.default_rng(lp * 1000 + max_insr)
    codes, dege, lengths, centers = _window_reads(rng, ref, lp, C)
    cg, dg = th._gridify(codes, dege, lengths, lp)
    got = [x.numpy() for x in kernels.window_batch(
        tal.dev_index("cpu").packed, tal.ref_len, torch.from_numpy(cg),
        torch.from_numpy(dg), torch.from_numpy(lengths.astype(np.int32)),
        torch.from_numpy(centers), C, 7)]
    want = [np.asarray(x) for x in jh._window_batch(
        lp, C, 7, jal._arrays()[3], jnp.int32(jal.ref_len), jnp.asarray(cg),
        jnp.asarray(dg), jnp.asarray(lengths.astype(np.int32)),
        jnp.asarray(centers))]
    nat = native.window_batch(tal._h_packed, tal.ref_len, codes, dege,
                              np.cumsum(lengths) - lengths, lengths, centers,
                              lp, C, 7)
    m = want[0]
    assert 20 <= m.sum() <= 56
    assert not m[9] and not m[18]                 # N bases never map
    if lp > 32:                     # short random reads can map by chance
        assert not m[5::8].any()
    if lp == 128:
        assert m[7::8].all() and not got[2][7::8].any()   # tie: forward
    assert got[2][m].any() and not got[2][m].all()        # both strands
    for other in (want, nat):
        assert np.array_equal(got[0], other[0])
        for a, b in zip(got[1:], other[1:]):
            assert np.array_equal(a[m], np.asarray(b)[m])


def _pairs(rng, ref, n, L=60):
    """n interleaved pairs: mate 1 clean, mate 2 the reverse complement
    150-400 bp downstream, a third of the mate 2s seedless (substitutions
    every 14 bases), some pairs unmappable."""
    reads = []
    for i in range(n):
        s = int(rng.integers(0, len(ref) - 600))
        ins = int(rng.integers(150, 400))
        m1 = ref[s:s + L].copy()
        m2 = ref[s + ins - L:s + ins].copy()
        if i % 3 == 0:
            at = np.arange(3, L, 12)
            m2[at] = (m2[at] + 1) % 4
        if i % 11 == 0:
            m1 = rng.integers(0, 4, L).astype(np.uint8)
        reads += [m1, (3 - m2)[::-1].copy()]
    lengths = np.array([len(r) for r in reads], np.int64)
    return np.concatenate(reads), np.zeros(int(lengths.sum()), bool), lengths


@pytest.fixture(scope="module")
def rescue_cases(tmp_path_factory):
    """{name: (port aligner, JAX aligner, codes, dege, lengths)}: the JAX
    package's own mate-rescue case (tests/test_aligned.py) and 200 random
    pairs."""
    d = tmp_path_factory.mktemp("pe_rescue")
    small = dict(slevel=0, lanes_min=16, lanes_max=32,
                 lane_target_symbols=512, seed_len=10, seed_max_occ=8,
                 seed_big_occ=32, max_mis=4, max_insr=500)
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 20_000).astype(np.uint8)
    fa = str(d / "ref.fa")
    with open(fa, "wb") as fh:
        fh.write(b">chr1 test\n" + _BASES[ref].tobytes() + b"\n")
    out = {}
    m1, m2 = ref[4000:4060].copy(), ref[4150:4210].copy()
    mut = np.arange(5, 60, 15)[:4]
    m2[mut] = (m2[mut] + 1) % 4
    out["jax_case"] = (small, np.concatenate([m1, m2]), np.zeros(120, bool),
                       np.full(2, 60, np.int64))
    out["random_200"] = (dict(small, seed_len=14, seed_max_occ=64,
                              seed_big_occ=1024, max_mis=7),
                         *_pairs(np.random.default_rng(8), ref, 200))
    res = {}
    for name, (kw, codes, dege, lengths) in out.items():
        tal = th.Aligner(tidx.build_from_ref(tidx.load_fasta(fa),
                                             CodecParams(**kw)),
                         CodecParams(**kw))
        jal = jh.Aligner(jidx.build_from_ref(jidx.load_fasta(fa),
                                             JParams(**kw)), JParams(**kw))
        res[name] = (tal, jal, codes, dege, lengths)
    return res


@pytest.mark.parametrize("route", ["", "device"])
@pytest.mark.parametrize("name", ["jax_case", "random_200"])
def test_rescue_mates_matches_jax(rescue_cases, name, route, monkeypatch):
    tal, jal, codes, dege, lengths = rescue_cases[name]
    jres = jal.align(codes, dege, lengths)
    want = jal.rescue_mates(codes, dege, lengths, jres, 500)
    monkeypatch.setenv("FASTQUEEZE_ALIGN_EXEC", route)
    native.ALIGN_CALLS["window_batch"] = 0
    tres = tal.align(codes, dege, lengths, "cpu")
    assert np.array_equal(tres.mapped, jres.mapped)
    got = tal.rescue_mates(codes, dege, lengths, tres, 500, "cpu")
    todo = ~tres.mapped & tres.mapped[np.arange(len(lengths)) ^ 1]
    assert native.ALIGN_CALLS["window_batch"] == int(route == ""
                                                     and todo.any())
    m = want.mapped
    if name == "random_200":
        assert m.sum() > jres.mapped.sum() + 30  # the window rescued mates
    assert np.array_equal(got.mapped, m)
    for f in ("pos", "is_rev", "mis_mask"):
        assert np.array_equal(getattr(got, f)[m], getattr(want, f)[m])
    if name == "jax_case":
        assert got.mapped[1] and got.pos[1] == 4150


# --- interleaving -----------------------------------------------------------

def _fastq(rng, n, lens=(0, 90), ids="sra", mate=0, n_frac=0.0, start=0):
    recs = []
    for r in range(n):
        L = int(rng.integers(*lens)) if lens[1] > lens[0] else lens[0]
        seq = bytearray(_BASES[rng.integers(0, 4, L)].tobytes())
        for j in np.flatnonzero(rng.random(L) < n_frac):
            seq[j] = ord("N")
        q = (rng.integers(2, 41, L) + 33).astype(np.uint8).tobytes()
        head = {"sra": b"@SRR0000001.%d %d length=%d" % (start + r + 1,
                                                         start + r + 1, L),
                "slash": b"@read_%d/%d" % (start + r, mate + 1)}[ids]
        recs.append(head + b"\n" + bytes(seq) + b"\n+\n" + q + b"\n")
    return b"".join(recs)


def test_interleave_matches_jax():
    rng = np.random.default_rng(4)
    raw1 = _fastq(rng, 300, mate=0, ids="slash")
    raw2 = _fastq(rng, 300, lens=(0, 3), mate=1, ids="slash")
    blocks = {}
    for name, fq, pe in (("j", jfq, jpe), ("t", tfq, tpe)):
        b1, b2 = fq.parse_block(raw1, True), fq.parse_block(raw2[:-1], False)
        assert isinstance(b1.ids, fq.LazyLines)
        merged = pe.interleave_blocks(b1, b2)
        blocks[name] = (merged, pe.deinterleave_block(merged, True, False))
    (jm, jback), (tm, tback) = blocks["j"], blocks["t"]
    assert (tm.lengths == 0).sum() > 50
    assert isinstance(tm.ids, tfq.LazyLines)
    assert tm.ids.cat == jm.ids.cat and np.array_equal(tm.ids.offs,
                                                       jm.ids.offs)
    assert list(tm.plus) == list(jm.plus)
    for f in ("n_reads", "raw_len", "final_newline"):
        assert getattr(tm, f) == getattr(jm, f)
    for f in ("seq_flat", "qual_flat", "lengths"):
        assert np.array_equal(getattr(tm, f), getattr(jm, f))
    assert tfq.assemble_block(tback[0]) == raw1
    assert tfq.assemble_block(tback[1]) == raw2[:-1]
    for a, b in zip(tback, jback):
        assert tfq.assemble_block(a) == jfq.assemble_block(b)


# --- archives ---------------------------------------------------------------

def _genome_pairs(rng, ref, n, seedless=0.0, L=100, ids="sra", indel=0.0):
    """(file 1, file 2) bytes: mate 1 forward at s, mate 2 the reverse
    complement ending at s + insert (200-500), ~0.5% substitutions, a few
    N bases; ``seedless`` of the mate 2s carry exactly the seven
    substitutions of _SEEDLESS instead (no 14-mer survives), and
    ``indel`` of the mate 1s a 2 bp deletion."""
    out = [[], []]
    for r in range(n):
        s = int(rng.integers(0, len(ref) - 600))
        ins = int(rng.integers(200, 501))
        m1 = ref[s:s + L].copy()
        if rng.random() < indel:
            at = int(rng.integers(30, 70))
            m1 = np.concatenate([ref[s:s + at], ref[s + at + 2:s + L + 2]])
        m2 = ref[s + ins - L:s + ins].copy()
        for m in (m1, m2):
            e = rng.random(L) < 0.005
            m[e] = (m[e] + 1) % 4
        if rng.random() < seedless:
            m2 = ref[s + ins - L:s + ins].copy()
            m2[_SEEDLESS] = (m2[_SEEDLESS] + 1) % 4
        for k, c in enumerate((m1, (3 - m2)[::-1])):
            seq = bytearray(_BASES[c].tobytes())
            if r % 37 == k:
                seq[int(rng.integers(0, L))] = ord("N")
            q = (np.clip(np.cumsum(rng.integers(-1, 2, L)) + 30, 2, 40)
                 + 33).astype(np.uint8)
            head = (b"@SRR0000001.%d %d length=%d" % (r + 1, r + 1, L)
                    if ids == "sra" else b"@pair_%d/%d" % (r, k + 1))
            out[k].append(head + b"\n" + bytes(seq) + b"\n+\n" + q.tobytes()
                          + b"\n")
    return b"".join(out[0]), b"".join(out[1])


def _coverage_pairs(rng, n):
    genome = rng.integers(0, 4, 8_000).astype(np.uint8)
    return _genome_pairs(rng, genome, n)


_CASES = {
    # name: (CodecParams fields, aligned, routes)
    "a_adaptive": (dict(), False, ("",)),
    "b_frozen": (dict(use_model=1, block_bytes=40_000), False, ("",)),
    "c_varlen": (dict(), False, ("",)),
    "d_selfref": (dict(self_align=1), False, ("",)),
    "e_aligned": (dict(), True, ("", "device")),
    "f_insert": (dict(max_insr=500), True, ("", "device")),
    "g_q_insert": (dict(seed_len=22, max_indel=3, max_insr=500), True,
                   ("",)),
}


def _inputs(name, rng, ref):
    if name == "b_frozen":
        return _genome_pairs(rng, ref, 400, ids="slash")
    if name == "c_varlen":
        r1 = _fastq(rng, 300, lens=(0, 140), n_frac=0.02)
        r2 = _fastq(rng, 300, lens=(20, 160), n_frac=0.02, mate=1)
        return r1, r2[:-1]                       # no final newline
    if name == "d_selfref":
        return _coverage_pairs(rng, 1200)
    return _genome_pairs(rng, ref, 300,
                         seedless=0.3 if "insert" in name else 0.0,
                         indel=0.2 if name == "g_q_insert" else 0.0)


@pytest.fixture(scope="module")
def pe_archives(tmp_path_factory):
    """{case: (in1, in2, ref or None, JAX archive, {route: port archive},
    port DebugInfo, {route: native aligner calls})}."""
    d = tmp_path_factory.mktemp("torch_pe")
    rng = np.random.default_rng(23)
    ref = rng.integers(0, 4, 30_000).astype(np.uint8)
    fa = str(d / "ref.fa")
    with open(fa, "wb") as fh:
        fh.write(b">c1\n" + _BASES[ref[:12_000]].tobytes() + b"\n>c2\n"
                 + _BASES[ref[12_000:]].tobytes() + b"\n")
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, (kw, aligned, routes) in _CASES.items():
            r1, r2 = _inputs(name, rng, ref)
            in1, in2 = str(d / f"{name}_1.fq"), str(d / f"{name}_2.fq")
            with open(in1, "wb") as f1, open(in2, "wb") as f2:
                f1.write(r1)
                f2.write(r2)
            fref = fa if aligned else None
            jarc = str(d / f"j_{name}.fqz")
            jpe.compress_pe(JParams(**kw), in1, in2, jarc, ref=fref)
            tarcs, dbg, calls = {}, DebugInfo(), {}
            for route in routes:
                for env in ("FASTQUEEZE_ALIGN_EXEC", "FASTQUEEZE_FROZEN_EXEC",
                            "FASTQUEEZE_ADAPT_EXEC"):
                    mp.setenv(env, route)
                for k in native.ALIGN_CALLS:
                    native.ALIGN_CALLS[k] = 0
                tarcs[route] = str(d / f"t{route}_{name}.fqz")
                tpe.compress_pe(CodecParams(**kw), in1, in2, tarcs[route],
                                ref=fref, dbg=dbg, device="cpu")
                calls[route] = dict(native.ALIGN_CALLS)
                mp.undo()
            out[name] = (in1, in2, fref, jarc, tarcs, dbg, calls)
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("name", sorted(_CASES))
def test_pe_archive_bytes_equal(pe_archives, name):
    in1, in2, ref, jarc, tarcs, dbg, calls = pe_archives[name]
    with open(jarc, "rb") as fh:
        want = fh.read()
    for arc in tarcs.values():
        with open(arc, "rb") as fh:
            assert fh.read() == want
    with ArcReader(jarc) as r:
        assert r.params.is_pe == 1 and len(r.input_md5s) == 2
        assert all(b.flags & FLAG_PE for b in r.blocks)
        bodies = [dict(iter_tlv(dict(iter_tlv(r.read_block(i)))[
            tpe.TAG_PE_BODY])) for i in range(len(r.blocks))]
        n_blocks, has_model, sa = (len(r.blocks), r.model_blob is not None,
                                   r.params.self_align)
    metas = [json.loads(b[blockcodec.TAG_META]) for b in bodies]
    if name == "b_frozen":
        assert n_blocks >= 3 and has_model
    if name == "d_selfref":
        assert sa == 1 and any(blockcodec.TAG_AMAP in b for b in bodies)
    if ref:
        assert sum(m["nm"] for m in metas) > 300
    if "insert" in name:
        assert all(blockcodec.TAG_APDF in b and blockcodec.TAG_APD in b
                   for b in bodies)
        assert dbg.vals["pe_rescued"] > 0
        assert dbg.vals["pe_both_map"] > 0
        assert calls[""]["window_batch"] > 0
    if ref:
        assert calls[""]["align_batch"] > 0
        assert sum(calls.get("device", {}).values()) == 0
    else:
        assert not any(blockcodec.TAG_APDF in b for b in bodies)
    if name == "g_q_insert":
        assert any(blockcodec.TAG_ACIGF in b for b in bodies)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_pe_cross_decode(pe_archives, name, tmp_path):
    in1, in2, ref, jarc, tarcs, _, _ = pe_archives[name]
    raws = [open(p, "rb").read() for p in (in1, in2)]
    td.decompress(jarc, str(tmp_path / "t"), force=True, device="cpu",
                  ref=ref)
    jd.decompress(tarcs[""], str(tmp_path / "j"), ref=ref, force=True)
    for out in ("t", "j"):
        for k in (1, 2):
            with open(tmp_path / f"{out}_{k}.fastq", "rb") as fh:
                assert fh.read() == raws[k - 1], (out, k)


@pytest.mark.parametrize("pipeout", [1, 2, 3])
def test_pipeout_matches_jax(pe_archives, pipeout, capfdbinary):
    _, _, _, jarc, tarcs, _, _ = pe_archives["c_varlen"]
    outs = []
    for call in (lambda: jd.decompress(jarc, None, pipeout=pipeout),
                 lambda: td.decompress(tarcs[""], None, device="cpu",
                                       pipeout=pipeout)):
        assert call() == []
        sys.stdout.flush()
        outs.append(capfdbinary.readouterr().out)
    assert outs[0] == outs[1] and len(outs[0]) > 1000


def test_se_pipeout_matches_jax(tmp_path, capfdbinary):
    fq = tmp_path / "se.fq"
    fq.write_bytes(_fastq(np.random.default_rng(2), 200))
    arc = str(tmp_path / "se.fqz")
    td.compress_se(CodecParams(), str(fq), arc, device="cpu")
    assert td.decompress(arc, None, device="cpu", pipeout=1) == []
    sys.stdout.flush()
    assert capfdbinary.readouterr().out == fq.read_bytes()


def test_pe_refusals(pe_archives, tmp_path):
    in1, in2 = pe_archives["a_adaptive"][:2]
    raw2 = open(in2, "rb").read()
    short, long_ = tmp_path / "short.fq", tmp_path / "long.fq"
    short.write_bytes(raw2[:raw2.rindex(b"@SRR")])
    long_.write_bytes(raw2 + raw2[:raw2.index(b"@SRR", 10)])
    for f2 in (short, long_):
        with pytest.raises(ValueError):
            tpe.compress_pe(CodecParams(), in1, str(f2),
                            str(tmp_path / "x.fqz"), device="cpu")
    # --part, once refused here, writes the JAX package's partial archive
    tpe.compress_pe(CodecParams(), in1, in2, str(tmp_path / "y.fqz"),
                    part=(0, 2), device="cpu")
    jpe.compress_pe(JParams(), in1, in2, str(tmp_path / "jy.fqz"),
                    part=(0, 2))
    assert (tmp_path / "y.fqz").read_bytes() == (
        tmp_path / "jy.fqz").read_bytes()
    with pytest.raises(ValueError, match=r"--mesh 2: only 1 device\(s\)"):
        tpe.compress_pe(CodecParams(mesh_n=2), in1, in2,
                        str(tmp_path / "y.fqz"), device="cpu")
    # the lossy transform, once refused here, writes the JAX archive
    jarc, tarc = str(tmp_path / "j.fqz"), str(tmp_path / "t.fqz")
    jpe.compress_pe(JParams(lossy_factor=1.2), in1, in2, jarc)
    tpe.compress_pe(CodecParams(lossy_factor=1.2), in1, in2, tarc,
                    device="cpu")
    assert open(jarc, "rb").read() == open(tarc, "rb").read()


def test_cli_takes_pe_flags(capsys, monkeypatch):
    from fastqueeze_tpu_torch import cli
    ap = cli.build_parser()
    args = ap.parse_args(["-c", "-1", "a.fq", "-2", "b.fq", "-I", "500",
                          "-S"])
    assert (args.in2, args.max_insr, args.self_align) == ("b.fq", 500, True)
    assert ap.parse_args(["-d", "x.fqz", "-P", "3"]).pipeout == 3
    # -2 is no longer refused as unported; without a card the CLI stops
    # before touching the inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-c", "-1", "a.fq", "-2", "b.fq", "-o", "x.fqz"]) == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "not ported" not in err
