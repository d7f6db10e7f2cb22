"""fastqueeze_tpu_torch's single-end path against fastqueeze_tpu, end to end.

compress_se of one seeded FASTQ through both packages (the JAX one with
FASTQUEEZE_FROZEN_EXEC=device, the port on the CPU with its plain kernel
versions) must give the same archive bytes with the quality-context
selection on, off (the fqz formula), and forced to a hashed rank chain
with pos bits; each package must decode the other's archive.  Also: the
port's errors for what it does not do yet, and that it imports without
JAX.
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
    fq = archives["qctx_off"][0]
    small = CodecParams()                   # below the usemodel gate
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        td.compress_se(small, fq, str(tmp_path / "a.fqz"), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        td.compress_se(CodecParams(use_model=1, self_align=1), fq,
                       str(tmp_path / "b.fqz"), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        td.compress_se(CodecParams(use_model=1, mesh_n=2), fq,
                       str(tmp_path / "c.fqz"), device="cpu")


@pytest.mark.parametrize("argv", [["--mesh", "2"], ["-S"], ["-2", "b.fq"],
                                  ["--part", "0:2"], ["ref.fa"]])
def test_cli_names_roadmap_item_for_unported_flags(argv, capsys):
    assert cli.main(["-c", "-1", "a.fq", "-o", "x.fqz"] + argv) == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_cli_refuses_to_run_without_a_card(tmp_path, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-c", "-1", "a.fq", "-o", str(tmp_path / "x")]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_package_imports_without_jax():
    code = ("import sys, fastqueeze_tpu_torch, fastqueeze_tpu_torch.cli, "
            "fastqueeze_tpu_torch.pipeline.driver, "
            "fastqueeze_tpu_torch.ops.kernels; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'fastqueeze_tpu' "
            "for m in sys.modules), 'reference package imported'")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
