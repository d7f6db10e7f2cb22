"""fastqueeze_tpu_torch's pipeline modes against fastqueeze_tpu.

-X (driver.extract: SE reads and PE pairs across a block boundary, and
the tail of an input without a final newline), -m (compress_multi and
the multi-file decode, adaptive and with a frozen model trained on the
first file), --part K:N and --merge (the parts of SE, SE with -l, PE and
reference-aligned inputs, one part written by each package, merged by
each package) must give the JAX package's files and archives byte for
byte, and each package must read the other's.  merge_archives' and the
decoders' refusals carry the JAX package's messages; the CLI takes the
reference's flags (-L, -n, -p, --block-mb, --slevel) and bounds --part.
Everything runs on the CPU (the native host coders and aligner), on a
few thousand reads.
"""

import os

import numpy as np
import pytest

from fastqueeze_tpu import cli as jcli
from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.container import arcfile as jarc
from fastqueeze_tpu.pipeline import aligned as ja
from fastqueeze_tpu.pipeline import driver as jd
from fastqueeze_tpu.pipeline import pe as jpe
from fastqueeze_tpu_torch import api, cli
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container import arcfile as tarc
from fastqueeze_tpu_torch.pipeline import aligned as ta
from fastqueeze_tpu_torch.pipeline import driver as td
from fastqueeze_tpu_torch.pipeline import pe as tpe

_BASES = np.frombuffer(b"ACGT", np.uint8)
_BLOCK = 60_000


def _records(rng, genome, n, tag=b"r"):
    """FASTQ records of 70-120 bp from ``genome`` (a few N bases, ~1%
    substitutions, ~40% reverse strand, random-walk qualities)."""
    recs = []
    for r in range(n):
        L = int(rng.integers(70, 121))
        s = int(rng.integers(0, len(genome) - L))
        c = genome[s:s + L].copy()
        e = rng.random(L) < 0.01
        c[e] = (c[e] + 1) % 4
        if rng.random() < 0.4:
            c = (3 - c)[::-1]
        seq = bytearray(_BASES[c].tobytes())
        if r % 31 == 0:
            seq[int(rng.integers(0, L))] = ord("N")
        q = (np.clip(np.cumsum(rng.integers(-1, 2, L)) + 30, 2, 40)
             + 33).astype(np.uint8)
        recs.append(b"@%s%d\n%s\n+\n%s\n" % (tag, r, bytes(seq),
                                             q.tobytes()))
    return recs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded inputs: se.fq (1,500 reads, no final newline), a pair of
    600 reads, three files of 400 reads, and ref.fa (the 30 kbp genome
    they are drawn from)."""
    d = tmp_path_factory.mktemp("torch_modes")
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 30_000).astype(np.uint8)
    out = {"dir": d, "ref": str(d / "ref.fa")}
    with open(out["ref"], "wb") as fh:
        fh.write(b">g\n" + _BASES[genome].tobytes() + b"\n")
    out["se"] = str(d / "se.fq")
    with open(out["se"], "wb") as fh:
        fh.write(b"".join(_records(rng, genome, 1500))[:-1])
    for k in (1, 2):
        out[f"pe{k}"] = str(d / f"pe_{k}.fq")
        with open(out[f"pe{k}"], "wb") as fh:
            fh.write(b"".join(_records(np.random.default_rng(30 + k),
                                       genome, 600, b"p")))
    out["multi"] = []
    for i in range(3):
        path = str(d / f"m{i}.fq")
        with open(path, "wb") as fh:
            fh.write(b"".join(_records(rng, genome, 400, b"m%d_" % i)))
        out["multi"].append(path)
    return out


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


# --- -X ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_archives(inputs):
    d = inputs["dir"]
    se, pe = str(d / "x_se.fqz"), str(d / "x_pe.fqz")
    jd.compress_se(JParams(block_bytes=_BLOCK), inputs["se"], se)
    jpe.compress_pe(JParams(block_bytes=_BLOCK), inputs["pe1"],
                    inputs["pe2"], pe)
    return {"se": se, "pe": pe}


_SLICES = {"se_boundary": ("se", -40, 90), "se_tail": ("se", None, 25),
           "pe_boundary": ("pe", -10, 30)}


@pytest.mark.parametrize("case", sorted(_SLICES))
def test_extract_matches_jax(inputs, jax_archives, case, tmp_path):
    """Slices across the block 0/1 boundary (reads of SE, pairs of PE)
    and the tail of the no-final-newline SE input: the port's files
    equal JAX extract's and the input's lines."""
    kind, at, count = _SLICES[case]
    arc = jax_archives[kind]
    with tarc.ArcReader(arc) as r:
        n0, total = r.blocks[0].n_reads, sum(b.n_reads for b in r.blocks)
        assert len(r.blocks) >= 3
    start = total - count if at is None else n0 + at
    jouts = jd.extract(arc, str(tmp_path / "j"), start, count)
    touts = api.extract(arc, start, count, str(tmp_path / "t"),
                        device="cpu")
    assert [os.path.basename(p)[1:] for p in touts] == [
        os.path.basename(p)[1:] for p in jouts]
    srcs = ([inputs["se"]] if kind == "se"
            else [inputs["pe1"], inputs["pe2"]])
    for jp, tp, src in zip(jouts, touts, srcs):
        assert _read(tp) == _read(jp)
        lines = _read(src).split(b"\n")
        want = b"\n".join(lines[4 * start:4 * (start + count)])
        if at is not None or src != inputs["se"]:
            want += b"\n"
        assert _read(tp) == want


# --- -m ------------------------------------------------------------------

@pytest.mark.parametrize("model", ["adaptive", "frozen"])
def test_multi_archive_matches_jax(inputs, model, tmp_path):
    kw = dict(block_bytes=_BLOCK, use_model=1 if model == "frozen" else 0)
    ja_, ta_ = str(tmp_path / "j.fqz"), str(tmp_path / "t.fqz")
    jd.compress_multi(JParams(**kw), inputs["multi"], ja_)
    stats = api.compress(inputs["multi"], ta_, params=CodecParams(**kw),
                         device="cpu")
    assert stats["files"] == 3
    assert _read(ta_) == _read(ja_)
    with tarc.ArcReader(ta_) as r:
        assert r.params.multi == 1 and r.params.self_align == 0
        assert (r.model_blob is not None) == (model == "frozen")
        assert sorted({b.file_id for b in r.blocks}) == [0, 1, 2]
    touts = td.decompress(ja_, str(tmp_path / "t"), device="cpu")
    jouts = jd.decompress(ta_, str(tmp_path / "j"))
    for src, t, j in zip(inputs["multi"], touts, jouts):
        assert _read(t) == _read(src) and _read(j) == _read(src)
    with pytest.raises(ValueError,
                       match="-X is not supported on multi-file archives"):
        td.extract(ta_, str(tmp_path / "x"), 0, 1, device="cpu")


# --- --part / --merge ------------------------------------------------------

def _compressors(inputs, case):
    """(JAX compressor, port compressor, params) of a --part case; each
    takes (params, out, part)."""
    se, fa = inputs["se"], inputs["ref"]
    pe1, pe2 = inputs["pe1"], inputs["pe2"]
    if case in ("se_frozen", "se_lossy"):
        kw = (dict(use_model=1) if case == "se_frozen"
              else dict(lossy_factor=1.3))
        return (lambda p, o, k: jd.compress_se(p, se, o, part=k),
                lambda p, o, k: td.compress_se(p, se, o, part=k,
                                               device="cpu"), kw)
    if case == "pe":
        return (lambda p, o, k: jpe.compress_pe(p, pe1, pe2, o, part=k),
                lambda p, o, k: tpe.compress_pe(p, pe1, pe2, o, part=k,
                                                device="cpu"), {})
    if case == "pe_aligned":
        return (lambda p, o, k: ja.compress_pe_aligned(p, fa, pe1, pe2, o,
                                                       part=k),
                lambda p, o, k: ta.compress_pe_aligned(p, fa, pe1, pe2, o,
                                                       part=k, device="cpu"),
                dict(max_insr=500))
    return (lambda p, o, k: ja.compress_se_aligned(p, fa, se, o, part=k),
            lambda p, o, k: ta.compress_se_aligned(p, fa, se, o, part=k,
                                                   device="cpu"), {})


@pytest.mark.parametrize("case", ["se_frozen", "se_lossy", "pe", "aligned",
                                  "pe_aligned"])
def test_parts_merge_to_the_single_run_archive(inputs, case, tmp_path):
    """--part 0:2 from the port, 1:2 from the JAX package: merged by
    either package, the JAX single-run archive byte for byte; the port's
    part 1 equals JAX's; a partial archive is refused on decode with the
    JAX message."""
    jc, tc, kw = _compressors(inputs, case)
    single = str(tmp_path / "single.fqz")
    jc(JParams(block_bytes=_BLOCK, **kw), single, None)
    p0, p1, t1 = (str(tmp_path / f"{n}.fqz") for n in ("p0", "p1", "t1"))
    tc(CodecParams(block_bytes=_BLOCK, **kw), p0, (0, 2))
    jc(JParams(block_bytes=_BLOCK, **kw), p1, (1, 2))
    tc(CodecParams(block_bytes=_BLOCK, **kw), t1, (1, 2))
    assert _read(t1) == _read(p1)
    tm, jm = str(tmp_path / "tm.fqz"), str(tmp_path / "jm.fqz")
    stats = api.merge(tm, [p1, p0])
    jarc.merge_archives(jm, [p0, p1])
    assert stats["parts"] == 2 and stats["blocks"] >= 3
    assert _read(tm) == _read(single) == _read(jm)
    ref = inputs["ref"] if "aligned" in case else None
    with pytest.raises(ValueError) as want:
        jd.decompress(p0, str(tmp_path / "x"), ref=ref, force=True)
    with pytest.raises(ValueError) as got:
        td.decompress(p0, str(tmp_path / "x"), ref=ref, force=True,
                      device="cpu")
    assert str(got.value) == str(want.value)
    assert "partial archive (part 0 of 2)" in str(got.value)


def _merge_cases(tmp_path, parts, single):
    """Inputs to merge_archives that it must refuse: (parts, force)."""
    other = str(tmp_path / "other.fqz")
    jd.compress_se(JParams(block_bytes=_BLOCK, use_model=0, qlevel=3),
                   parts["se"], other, part=(1, 2))
    three = str(tmp_path / "three.fqz")
    jd.compress_se(JParams(block_bytes=_BLOCK), parts["se"], three,
                   part=(1, 3))
    return {
        "not_partial": ([parts[0], single], True),
        "n_mismatch": ([parts[0], three], True),
        "duplicate": ([parts[0], parts[0]], True),
        "missing": ([parts[1]], True),
        "section_differs": ([parts[0], other], True),
        "exists": ([parts[0], parts[1]], False),
    }


def test_merge_refusals_match_jax(inputs, tmp_path):
    se = inputs["se"]
    single = str(tmp_path / "single.fqz")
    jd.compress_se(JParams(block_bytes=_BLOCK), se, single)
    parts = {"se": se}
    for k in (0, 1):
        parts[k] = str(tmp_path / f"p{k}.fqz")
        jd.compress_se(JParams(block_bytes=_BLOCK), se, parts[k],
                       part=(k, 2))
    out = str(tmp_path / "out.fqz")
    for name, (paths, force) in _merge_cases(tmp_path, parts,
                                             single).items():
        with open(out, "wb") as fh:
            fh.write(b"x")                 # in place: refused unless force
        msgs = []
        for merge in (jarc.merge_archives, tarc.merge_archives):
            with pytest.raises(ValueError) as e:
                merge(out, paths, force=force)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], name


# --- the CLI ---------------------------------------------------------------

def test_cli_list_equals_jax(inputs, jax_archives, tmp_path, capsys):
    part = str(tmp_path / "p.fqz")
    jd.compress_se(JParams(block_bytes=_BLOCK), inputs["se"], part,
                   part=(1, 3))
    for arc in (jax_archives["pe"], part):
        outs = []
        for main in (jcli.main, cli.main):
            assert main(["-L", arc]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
    assert "PARTIAL (part 1 of 3)" in outs[1]


def test_cli_takes_the_reference_flags():
    ap = cli.build_parser()
    a = ap.parse_args(["-c", "-n", "-p", "--block-mb", "8", "--slevel", "2",
                       "-1", "a.fq", "-1", "b.fq", "-1", "c.fq", "-m",
                       "--part", "1:3", "-o", "x.fqz"])
    assert (a.no_orderbin, a.indir, a.block_mb, a.slevel, a.multi,
            a.in1, a.part) == (True, True, 8, 2, True,
                               ["a.fq", "b.fq", "c.fq"], "1:3")
    a = ap.parse_args(["--merge", "p0.fqz", "p1.fqz", "-o", "m.fqz"])
    assert a.merge and a.pos == ["p0.fqz", "p1.fqz"]
    assert ap.parse_args(["-d", "x.fqz", "-X", "10:5"]).extract == "10:5"


@pytest.mark.parametrize("spec,want", [
    ("0:2", (0, 2)), ("3:4", (3, 4)), ("0:1", None),
    ("0:4294967295", (0, 4294967295)),
    ("0:4294967296", "--part 0:4294967296: need 0 <= K < N <= 2^32-1"),
    ("2:2", "--part 2:2: need 0 <= K < N <= 2^32-1"),
    ("a:2", "--part wants K:N (e.g. --part 0:4)")])
def test_cli_part_bounds(spec, want):
    """The bound of api.compress, which the JAX CLI's parse lacks (k < n
    only): a part count past 2^32-1 would not fit the PART section."""
    assert cli._parse_part(spec) == want
