"""fastqueeze_tpu_torch's single-end path against fastqueeze_tpu, end to end.

compress_se of one seeded FASTQ through both packages (the JAX one with
FASTQUEEZE_FROZEN_EXEC=device, the port on the CPU with its plain kernel
versions) must give the same archive bytes with the quality-context
selection on, off (the fqz formula), and forced to a hashed rank chain
with pos bits; each package must decode the other's archive.  The same
holds for the adaptive coder: the input below the usemodel gate at
defaults and at qlevel 3 (the port's seq/qual through its engine,
FASTQUEEZE_ADAPT_EXEC=device; the JAX package at its defaults), and a
frozen-path input with Illumina IDs and host_stream_max=0, whose length,
flag, distance, degenerate-base and ID streams all take marker 1.  Also:
frozen_adapt and adapt_chunk archives, the port's errors for what it does
not do yet, and that it imports without JAX.  The aligned and self-referential paths are in
tests/test_torch_align.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.pipeline import driver as jd
from fastqueeze_tpu_torch import cli
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import ArcReader
from fastqueeze_tpu_torch.container.encap import iter_tlv, write_tlv
from fastqueeze_tpu_torch.pipeline import blockcodec
from fastqueeze_tpu_torch.pipeline import driver as td
from fastqueeze_tpu_torch.pipeline.frozen import deserialize_frozen
from fastqueeze_tpu_torch.ops import kernels

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_CONFIGS = {
    "qctx_on": dict(qctx_auto=1),
    "qctx_off": dict(qctx_auto=0),
    "chain_k4_hash_pos": dict(qctx_k=4, qctx_hash_bits=14, qctx_pos_bits=3,
                              qctx_init=1, qctx_inc=16),
}


def _fastq(path, n=1000, seed=11):
    """Seeded reads of 60-140 bp from a small random genome: a few N
    bases, one exact duplicate, binned random-walk qualities, SRA-style
    IDs, no final newline."""
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
        recs.append(b"@SRR0000001.%d %d length=%d\n" % (r + 1, r + 1, L)
                    + bytes(seq) + b"\n+\n"
                    + bytes((bins[walk] + 33).astype(np.uint8)) + b"\n")
    recs[10] = recs[3]
    with open(path, "wb") as fh:
        fh.write(b"".join(recs)[:-1])


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """{config: (input, jax archive, port archive, jax params)}."""
    d = tmp_path_factory.mktemp("torch_pipeline")
    fq = str(d / "in.fq")
    _fastq(fq)
    mp = pytest.MonkeyPatch()
    mp.setenv("FASTQUEEZE_FROZEN_EXEC", "device")
    out = {}
    try:
        for name, kw in _CONFIGS.items():
            jp = JParams(block_bytes=20000, use_model=1, **kw)
            ja, ta = str(d / f"j_{name}.fqz"), str(d / f"t_{name}.fqz")
            jd.compress_se(jp, fq, ja)
            td.compress_se(CodecParams(block_bytes=20000, use_model=1, **kw),
                           fq, ta, device="cpu")
            out[name] = (fq, ja, ta, jp)
        yield out
    finally:
        mp.undo()


def _illumina_fastq(path, n=300, seed=5):
    """Seeded reads of 30-150 bp with Illumina-style IDs (tile, x, y
    vary), a few N bases and one exact duplicate."""
    rng = np.random.default_rng(seed)
    recs = []
    for r in range(n):
        L = int(rng.integers(30, 151))
        seq = bytearray(rng.choice(list(b"ACGT"), L).astype(np.uint8))
        if r % 23 == 0:
            seq[int(rng.integers(0, L))] = ord("N")
        qual = (np.clip(np.cumsum(rng.integers(-2, 3, L)) + 30, 2, 41)
                + 33).astype(np.uint8)
        recs.append(b"@A00123:45:HXXXXDSXX:1:%d:%d:%d 1:N:0:ACGTACGT\n"
                    b"%s\n+\n%s\n" % (1101 + r // 100,
                                       int(rng.integers(1000, 32000)),
                                       int(rng.integers(1000, 32000)),
                                       bytes(seq), bytes(qual)))
    recs[40] = recs[7]
    with open(path, "wb") as fh:
        fh.write(b"".join(recs))


_ADAPTIVE = {
    "subgate_defaults": dict(),
    "subgate_qlevel3": dict(qlevel=3),
    "marker1_streams": dict(use_model=1, host_stream_max=0),
}


@pytest.fixture(scope="module")
def adaptive_archives(tmp_path_factory):
    """{config: (input, jax archive, port archive)}."""
    d = tmp_path_factory.mktemp("torch_adaptive")
    fq_sub, fq_ill = str(d / "in.fq"), str(d / "illumina.fq")
    _fastq(fq_sub)
    _illumina_fastq(fq_ill)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, kw in _ADAPTIVE.items():
            fq = fq_ill if name.startswith("marker1") else fq_sub
            ja, ta = str(d / f"j_{name}.fqz"), str(d / f"t_{name}.fqz")
            jd.compress_se(JParams(**kw), fq, ja)
            mp.setenv("FASTQUEEZE_ADAPT_EXEC", "device")
            td.compress_se(CodecParams(**kw), fq, ta, device="cpu")
            mp.delenv("FASTQUEEZE_ADAPT_EXEC")
            out[name] = (fq, ja, ta)
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("name", sorted(_ADAPTIVE))
def test_adaptive_archive_bytes_equal(adaptive_archives, name):
    fq, ja, ta = adaptive_archives[name]
    with open(ja, "rb") as a, open(ta, "rb") as b:
        assert a.read() == b.read()
    with ArcReader(ta) as r:
        assert (r.model_blob is not None) == name.startswith("marker1")
        secs = dict(iter_tlv(r.read_block(0)))
    if name.startswith("marker1"):
        for tag in (blockcodec.TAG_LEN, blockcodec.TAG_SDUPF,
                    blockcodec.TAG_SDUPD, blockcodec.TAG_QDUPF,
                    blockcodec.TAG_QDUPD, blockcodec.TAG_DEGCNT,
                    blockcodec.TAG_DEGPOS, blockcodec.TAG_IDVAR):
            assert secs[tag][:1] == b"\x01", tag


@pytest.mark.parametrize("name", sorted(_ADAPTIVE))
def test_adaptive_cross_decode(adaptive_archives, name, tmp_path,
                               monkeypatch):
    fq, ja, ta = adaptive_archives[name]
    with open(fq, "rb") as fh:
        raw = fh.read()
    monkeypatch.setenv("FASTQUEEZE_ADAPT_EXEC", "device")
    kernels.reset_launch_counts()
    td.decompress(ja, str(tmp_path / "t"), force=True, device="cpu")
    monkeypatch.delenv("FASTQUEEZE_ADAPT_EXEC")
    jd.decompress(ta, str(tmp_path / "j"), force=True)
    for out in ("t", "j"):
        with open(tmp_path / f"{out}.fastq", "rb") as fh:
            assert fh.read() == raw


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_archive_bytes_equal(archives, name):
    fq, ja, ta, jp = archives[name]
    assert (jp.qctx_k >= 2) == name.startswith("chain")
    with open(ja, "rb") as a, open(ta, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_cross_decode(archives, name, tmp_path, monkeypatch):
    monkeypatch.setenv("FASTQUEEZE_FROZEN_EXEC", "device")
    fq, ja, ta, _ = archives[name]
    with open(fq, "rb") as fh:
        raw = fh.read()
    td.decompress(ja, str(tmp_path / "t"), force=True, device="cpu")
    jd.decompress(ta, str(tmp_path / "j"), force=True)
    for name in ("t", "j"):
        with open(tmp_path / f"{name}.fastq", "rb") as fh:
            assert fh.read() == raw


def test_corrupt_seq_payload_raises_value_error(archives):
    fq, _, ta, _ = archives["qctx_off"]
    with ArcReader(ta) as r:
        p, payload = r.params, r.read_block(0)
        frozen = deserialize_frozen(r.model_blob)
    secs = list(iter_tlv(payload))
    bad = []
    for tag, val in secs:
        if tag == blockcodec.TAG_SEQ:
            val = val[:12] + b"\xff" * 4 + val[16:]   # symbol count
        bad.append(write_tlv(tag, val))
    with pytest.raises(ValueError):
        blockcodec.decode_block(p, b"".join(bad), frozen, "cpu")


def test_unported_paths_raise(tmp_path, archives):
    """frozen_adapt, adapt_chunk and the lossy transform, once refused, now
    write the JAX package's archive (a cut of 200 reads); --mesh over more
    devices than are visible raises the JAX package's ValueError."""
    fq = archives["qctx_off"][0]
    with open(fq, "rb") as fh:
        lines = fh.read().split(b"\n")
    small = tmp_path / "small.fq"
    small.write_bytes(b"\n".join(lines[:800]) + b"\n")
    for kw in (dict(use_model=1, frozen_adapt=1), dict(adapt_chunk=128),
               dict(use_model=1, lossy_factor=2.0)):
        ja, ta = str(tmp_path / "j.fqz"), str(tmp_path / "t.fqz")
        jd.compress_se(JParams(**kw), str(small), ja)
        td.compress_se(CodecParams(**kw), str(small), ta, device="cpu")
        with open(ja, "rb") as a, open(ta, "rb") as b:
            assert a.read() == b.read(), kw
    with pytest.raises(ValueError, match=r"--mesh 2: only 1 device\(s\)"):
        td.compress_se(CodecParams(use_model=1, mesh_n=2), fq,
                       str(tmp_path / "c.fqz"), device="cpu")


@pytest.mark.parametrize("argv,rc,says", [
    (["--mesh", "2"], 1, "--mesh 2: only 1 device(s) visible"),
    (["-m", "-S"], 2, "-S is reference-free (no ref.fa / -m)"),
    (["-2", "b.fq", "-m"], 2, "-m supports plain SE inputs"),
    (["--part", "0:2", "-m"], 2, "--part is not supported with -m"),
    (["--part", "0:4294967296"], 2, "need 0 <= K < N <= 2^32-1")])
def test_cli_names_roadmap_item_for_unported_flags(argv, rc, says, capsys,
                                                   monkeypatch):
    """-m, -X and --part, once refused with ROADMAP Queue A item 4, are
    ported: what stays refused is the JAX CLI's misuse of them, with its
    messages, and a part count past 2^32-1; --mesh over the visible
    devices is refused with the device count."""
    import torch
    # one visible card: --mesh 2 asks for more devices than there are
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert cli.main(["-c", "-1", "a.fq", "-o", "x.fqz"] + argv) == rc
    err = capsys.readouterr().err
    assert says in err and "ROADMAP" not in err


def test_cli_refuses_to_run_without_a_card(tmp_path, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-c", "-1", "a.fq", "-o", str(tmp_path / "x")]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_package_imports_without_jax():
    code = ("import sys, fastqueeze_tpu_torch, fastqueeze_tpu_torch.cli, "
            "fastqueeze_tpu_torch.pipeline.driver, "
            "fastqueeze_tpu_torch.pipeline.aligned, "
            "fastqueeze_tpu_torch.pipeline.selfref, "
            "fastqueeze_tpu_torch.ops.kernels, fastqueeze_tpu_torch.api; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'fastqueeze_tpu' "
            "for m in sys.modules), 'reference package imported'")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
