"""fastqueeze_tpu_torch's long-read chunk tier, -l lossy and --mesh on one
device against fastqueeze_tpu.

Long reads: reads over align_max_len mixed with short ones, aligned SE
and PE by the port on the CPU through the native host mirror, the plain
versions of K8/K9 (FASTQUEEZE_ALIGN_EXEC=device) and the fused flow
(FASTQUEEZE_FUSED_ALIGN=1: K8 and K14's plain versions), must give the
JAX package's FASTQUEEZE_ALIGN_EXEC=host archive byte for byte, and each
package decodes the other's.  -l 1.15 archives (SE adaptive and frozen,
PE, aligned SE) and their decoded FASTQ equal the JAX package's; lossy,
part and mesh_n through the api behave as the JAX api's.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from genome_fixture import make_genome, write_fasta  # noqa: E402

from fastqueeze_tpu import api as japi  # noqa: E402
from fastqueeze_tpu.config import CodecParams as JParams  # noqa: E402
from fastqueeze_tpu.pipeline import aligned as ja  # noqa: E402
from fastqueeze_tpu.pipeline import driver as jd  # noqa: E402
from fastqueeze_tpu.pipeline import pe as jpe  # noqa: E402
from fastqueeze_tpu_torch import api  # noqa: E402
from fastqueeze_tpu_torch.config import CodecParams  # noqa: E402
from fastqueeze_tpu_torch.container.arcfile import ArcReader  # noqa: E402
from fastqueeze_tpu_torch.container.encap import iter_tlv  # noqa: E402
from fastqueeze_tpu_torch.io import native  # noqa: E402
from fastqueeze_tpu_torch.pipeline import aligned as ta  # noqa: E402
from fastqueeze_tpu_torch.pipeline import blockcodec  # noqa: E402
from fastqueeze_tpu_torch.pipeline import driver as td  # noqa: E402
from fastqueeze_tpu_torch.pipeline import pe as tpe  # noqa: E402
from fastqueeze_tpu_torch.pipeline.lossy import rblock_transform  # noqa: E402
from fastqueeze_tpu_torch.utils.metrics import DebugInfo  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them from stalling on busy cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_LETTERS = np.frombuffer(b"ACGTN", np.uint8)
# serialized PARAM fields, so both packages take them; they keep the
# plain versions' chunk grids small
_SMALL = dict(align_max_len=512, longread_chunk=256)


def _records(rng, codes):
    """12 reads of 3,000-9,000 bp (~0.3% substitutions, a third reverse
    strand, two with a 2 bp deletion, one with an N, one the exact
    duplicate of another) and 150 reads of 100 bp, shuffled together."""
    recs = []
    for i in range(11):
        L = int(rng.integers(3000, 9000))
        st = int(rng.integers(0, len(codes) - L - 8))
        r = np.minimum(codes[st:st + L + 2], 3)
        if i in (2, 5):
            at = int(rng.integers(300, L - 300))
            r = np.concatenate([r[:at], r[at + 2:]])
        r = r[:L].copy()
        err = rng.random(L) < 0.003
        r[err] ^= rng.integers(1, 4, int(err.sum())).astype(np.uint8)
        if i % 3 == 0:
            r = (3 - r)[::-1]
        if i == 7:
            r[L // 2] = 4
        q = (rng.integers(20, 41, L) + 33).astype(np.uint8)
        recs.append(b"@L%d\n%s\n+\n%s\n" % (i, _LETTERS[r].tobytes(),
                                            q.tobytes()))
    recs.append(recs[4].replace(b"@L4\n", b"@L4dup\n"))
    for i in range(150):
        st = int(rng.integers(0, len(codes) - 100))
        r = np.minimum(codes[st:st + 100], 3)
        if i % 3 == 0:
            r = (3 - r)[::-1]
        q = (rng.integers(2, 41, 100) + 33).astype(np.uint8)
        recs.append(b"@S%d\n%s\n+\n%s\n" % (i, _LETTERS[r].tobytes(),
                                            q.tobytes()))
    return [recs[j] for j in rng.permutation(len(recs))]


@pytest.fixture(scope="module")
def lr_inputs(tmp_path_factory):
    """(ref.fa, SE FASTQ, PE FASTQ pair) over a ~200 kbp genome."""
    d = tmp_path_factory.mktemp("torch_longread")
    codes, bounds = make_genome(200_000, seed=11)
    fa = str(d / "ref.fa")
    write_fasta(codes, bounds, fa)
    recs = _records(np.random.default_rng(12), codes)
    fq = str(d / "lr.fq")
    with open(fq, "wb") as fh:
        fh.write(b"".join(recs))
    half = len(recs) // 2
    pe = (str(d / "lr_1.fq"), str(d / "lr_2.fq"))
    for path, part in zip(pe, (recs[:half], recs[half:2 * half])):
        with open(path, "wb") as fh:
            fh.write(b"".join(part))
    return fa, fq, pe


_ROUTES = {"host": ("host", "0"), "device": ("device", "0"),
           "fused": ("device", "1")}


def _compress(pkg, layout, kw, fa, fq, pe, out):
    """One aligned compress of the SE or PE input by either package."""
    if pkg == "j":
        P = JParams(**kw)
        if layout == "se":
            return ja.compress_se_aligned(P, fa, fq, out)
        return jpe.compress_pe(P, *pe, out, ref=fa)
    P, dbg = CodecParams(**kw), DebugInfo()
    if layout == "se":
        ta.compress_se_aligned(P, fa, fq, out, dbg=dbg, device="cpu")
    else:
        tpe.compress_pe(P, *pe, out, ref=fa, dbg=dbg, device="cpu")
    return dbg.vals


@pytest.fixture(scope="module")
def lr_archives(lr_inputs, tmp_path_factory):
    """{(layout, params): {"j": JAX host-route archive, route: (port
    archive, its stats)}}."""
    fa, fq, pe = lr_inputs
    d = tmp_path_factory.mktemp("torch_longread_arcs")
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for layout, tag, kw, routes in (
                ("se", "small", _SMALL, _ROUTES),
                ("pe", "small", _SMALL, _ROUTES),
                ("se", "defaults", {}, ("host",))):
            arcs = {}
            mp.setenv("FASTQUEEZE_ALIGN_EXEC", "host")
            arcs["j"] = str(d / f"j_{layout}_{tag}.fqz")
            _compress("j", layout, kw, fa, fq, pe, arcs["j"])
            for route in routes:
                mode, fused = _ROUTES[route]
                mp.setenv("FASTQUEEZE_ALIGN_EXEC", mode)
                mp.setenv("FASTQUEEZE_FUSED_ALIGN", fused)
                arc = str(d / f"t_{layout}_{tag}_{route}.fqz")
                native.ALIGN_CALLS["align_batch"] = 0
                stats = _compress("t", layout, kw, fa, fq, pe, arc)
                arcs[route] = (arc, stats, native.ALIGN_CALLS["align_batch"])
            mp.undo()
            out[(layout, tag)] = arcs
        yield out
    finally:
        mp.undo()


_CASES = ([("se", "small", r) for r in _ROUTES]
          + [("pe", "small", r) for r in _ROUTES]
          + [("se", "defaults", "host")])


@pytest.mark.parametrize("layout,tag,route", _CASES)
def test_longread_archive_equals_jax(lr_archives, layout, tag, route):
    arcs = lr_archives[(layout, tag)]
    arc, stats, native_calls = arcs[route]
    with open(arcs["j"], "rb") as a, open(arc, "rb") as b:
        assert a.read() == b.read()
    assert stats["lr_chunks_mapped"] > 20
    assert (native_calls > 0) == (route == "host")
    with ArcReader(arc) as r:
        secs = [dict(iter_tlv(r.read_block(i))) for i in range(len(r.blocks))]
    if layout == "pe":
        secs = [dict(iter_tlv(s[tpe.TAG_PE_BODY])) for s in secs]
    assert any(blockcodec.TAG_LRF in s for s in secs)
    if tag == "small":
        # the two deletions land inside chunks: the chunk indel tier
        assert any(blockcodec.TAG_LRCIGF in s for s in secs)


@pytest.mark.parametrize("layout,tag", [("se", "small"), ("pe", "small"),
                                        ("se", "defaults")])
def test_longread_cross_decode(lr_inputs, lr_archives, layout, tag,
                               tmp_path):
    fa, fq, pe = lr_inputs
    arcs = lr_archives[(layout, tag)]
    td.decompress(arcs["j"], str(tmp_path / "t"), force=True, device="cpu",
                  ref=fa)
    jd.decompress(arcs["host"][0], str(tmp_path / "j"), ref=fa, force=True)
    for out in ("t", "j"):
        if layout == "se":
            pairs = [(fq, tmp_path / f"{out}.fastq")]
        else:
            pairs = [(pe[i], tmp_path / f"{out}_{i + 1}.fastq")
                     for i in (0, 1)]
        for src, got in pairs:
            with open(src, "rb") as a, open(got, "rb") as b:
                assert a.read() == b.read()


# --- -l lossy ---------------------------------------------------------------

def _short_fastq(path, rng, n):
    bases = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(n):
        q = np.clip(np.cumsum(rng.integers(-2, 3, 100)) + 30, 2, 40) + 33
        recs.append(b"@r%d\n%s\n+\n%s\n" % (
            i, bases[rng.integers(0, 4, 100)].tobytes(),
            q.astype(np.uint8).tobytes()))
    with open(path, "wb") as fh:
        fh.write(b"".join(recs))


_LOSSY = ["se_adaptive", "se_frozen", "pe", "aligned_se"]


@pytest.mark.parametrize("case", _LOSSY)
def test_lossy_archive_and_fastq_equal_jax(case, lr_inputs, tmp_path):
    """-l 1.15: the port's archive and its decoded FASTQ equal the JAX
    package's; the decoded qualities are the transform of the input's."""
    fa = lr_inputs[0]
    kw = dict(lossy_factor=1.15)
    rng = np.random.default_rng(21)
    fq, fq2 = str(tmp_path / "a.fq"), str(tmp_path / "b.fq")
    _short_fastq(fq, rng, 400)
    _short_fastq(fq2, rng, 400)
    if case == "se_frozen":
        kw.update(use_model=1, block_bytes=30_000)
    arcs = {w: str(tmp_path / f"{w}.fqz") for w in ("j", "t")}
    if case == "aligned_se":
        fq = lr_inputs[1]
        ja.compress_se_aligned(JParams(**kw), fa, fq, arcs["j"])
        ta.compress_se_aligned(CodecParams(**kw), fa, fq, arcs["t"],
                               device="cpu")
    elif case == "pe":
        jpe.compress_pe(JParams(**kw), fq, fq2, arcs["j"])
        tpe.compress_pe(CodecParams(**kw), fq, fq2, arcs["t"], device="cpu")
    else:
        jd.compress_se(JParams(**kw), fq, arcs["j"])
        td.compress_se(CodecParams(**kw), fq, arcs["t"], device="cpu")
    with open(arcs["j"], "rb") as a, open(arcs["t"], "rb") as b:
        assert a.read() == b.read()
    ref = fa if case == "aligned_se" else None
    td.decompress(arcs["t"], str(tmp_path / "t"), force=True, device="cpu",
                  ref=ref)
    jd.decompress(arcs["j"], str(tmp_path / "j"), ref=ref, force=True)
    names = (["_1.fastq", "_2.fastq"] if case == "pe" else [".fastq"])
    for n in names:
        with open(tmp_path / f"t{n}", "rb") as a, \
                open(tmp_path / f"j{n}", "rb") as b:
            assert a.read() == b.read()
    src = open(fq, "rb").read().split(b"\n")
    got = open(tmp_path / f"t{names[0]}", "rb").read().split(b"\n")
    assert got[1::4] == src[1::4] and got[3::4] != src[3::4]
    q = np.frombuffer(b"".join(src[3::4]), np.uint8).astype(np.int32) - 33
    lens = np.array([len(x) for x in src[3::4]], np.int64)
    want = (rblock_transform(q, lens, 1.15) + 33).astype(np.uint8)
    assert b"".join(got[3::4]) == want.tobytes()


# --- Queue C: lossy, part and mesh_n through the api -------------------------

@pytest.mark.parametrize("case", ["lossy_1", "mesh_1", "mesh_all_t8"])
def test_api_params_write_the_jax_archive(case, tmp_path):
    """lossy=1.0 sets PARAM's lossy_factor without a transform, mesh=1 is a
    no-op on one device, and mesh=-1 at threads=8 writes the JAX archive
    (the JAX test process sees 8 devices and widens threads to 8)."""
    fq = str(tmp_path / "in.fq")
    _short_fastq(fq, np.random.default_rng(22), 300)
    kw = {"lossy_1": dict(lossy=1.0), "mesh_1": dict(mesh=1),
          "mesh_all_t8": dict(mesh=-1, threads=8)}[case]
    api.compress(fq, str(tmp_path / "t.fqz"), device="cpu", **kw)
    japi.compress(fq, str(tmp_path / "j.fqz"), **kw)
    assert ((tmp_path / "t.fqz").read_bytes()
            == (tmp_path / "j.fqz").read_bytes())
    with ArcReader(str(tmp_path / "t.fqz")) as r:
        if case == "lossy_1":
            assert r.params.lossy_factor == 1.0
        else:
            assert r.params.mesh_n == kw["mesh"]
    api.decompress(str(tmp_path / "t.fqz"), str(tmp_path / "back"),
                   device="cpu")
    assert (tmp_path / "back.fastq").read_bytes() == open(fq, "rb").read()


@pytest.mark.parametrize("case", ["part", "mesh_2"])
def test_api_refusals_match_jax(case, tmp_path):
    """part=(5, 1) raises the JAX api's ValueError; mesh=2 is refused with
    the device count (the JAX message, for one visible device)."""
    fq = str(tmp_path / "in.fq")
    _short_fastq(fq, np.random.default_rng(23), 50)
    arc = str(tmp_path / "x.fqz")
    if case == "part":
        msgs = []
        for fn in (japi.compress, lambda *a, **k: api.compress(
                *a, device="cpu", **k)):
            with pytest.raises(ValueError) as e:
                fn(fq, arc, part=(5, 1))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    else:
        with pytest.raises(ValueError,
                           match=r"^--mesh 2: only 1 device\(s\) visible$"):
            api.compress(fq, arc, mesh=2, device="cpu")
