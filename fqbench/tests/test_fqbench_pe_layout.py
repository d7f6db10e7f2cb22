"""reference/pe_layout.py against the port's paired-end archives on the
CPU: the block table (pairs, each file's plaintext bytes, the MD5 of the
pair's plaintext) and both whole-file MD5s equal the reference's on
seeded pairs from the benchmark's generator and on pairs of mates of
different lengths whose file 2 has no final newline; an archive cut
otherwise does not; and the port's interleave and deinterleave give the
reference's record order."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import gen  # noqa: E402
from fqbench.reference import pe_layout  # noqa: E402
from fastqueeze_tpu_torch.config import CodecParams  # noqa: E402
from fastqueeze_tpu_torch.container.arcfile import ArcReader  # noqa: E402
from fastqueeze_tpu_torch.io.fastq import (  # noqa: E402
    assemble_block, parse_block)
from fastqueeze_tpu_torch.pipeline import pe  # noqa: E402

READS = {"kind": "pe", "length": 100, "genome_bp": 1_000_000,
         "sub_rate": 0.01, "n_rate": 0.001, "qual_states": 40, "ids": "sra",
         "insert_min": 200, "insert_max": 500}
BLOCK = 150_000     # 75 kB of file 1 a block pair


def _varlen_pairs(n, seed):
    """Seeded pairs whose mates have their own lengths (0-160 bp), IDs
    equal in both files, and a file 2 without its final newline."""
    rng = np.random.default_rng(seed)
    out = ([], [])
    for r in range(n):
        for k in (0, 1):
            L = int(rng.integers(0, 161))
            seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, L)]
            q = (rng.integers(2, 42, L) + 33).astype(np.uint8)
            out[k].append(b"@SRR0000001.%d %d length=%d\n" % (r + 1, r + 1, L)
                          + seq.tobytes() + b"\n+\n" + q.tobytes() + b"\n")
    return b"".join(out[0]), b"".join(out[1])[:-1]


INPUTS = {
    "generator": lambda: [f.tobytes() for f in gen.pe_fastq(
        2**31 + 77, 3000, READS)],
    "varlen_no_final_newline": lambda: _varlen_pairs(1500, 5),
}


def _compress(tmp_path, files, **kw):
    paths = [str(tmp_path / f"in_{k}.fq") for k in (1, 2)]
    for path, data in zip(paths, files):
        with open(path, "wb") as fh:
            fh.write(data)
    arc = str(tmp_path / "x.fqz")
    pe.compress_pe(CodecParams(block_bytes=BLOCK, **kw), *paths, arc,
                   device="cpu")
    with ArcReader(arc) as r:
        return ([pe_layout.BlockPair(b.n_reads, b.raw_len1, b.raw_len2,
                                     b.md5) for b in r.blocks],
                list(r.input_md5s))


@pytest.mark.parametrize("kw", [{}, {"use_model": 1}],
                         ids=("adaptive", "frozen"))
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_archive_layout_is_the_references(tmp_path, name, kw):
    files = INPUTS[name]()
    blocks, md5s = _compress(tmp_path, files, **kw)
    want_blocks, want_md5s = pe_layout.layout(*files, BLOCK)
    assert len(want_blocks) >= 3
    assert blocks == want_blocks and md5s == want_md5s
    assert sum(b.n_pairs for b in blocks) == pe_layout.records_of(files[0])


def test_an_archive_cut_otherwise_is_not(tmp_path, monkeypatch):
    """Block pairs cut at the whole block size instead of half of it: the
    reference tells the table apart."""
    files = INPUTS["generator"]()
    monkeypatch.setattr(pe, "block_bytes", lambda p: 2 * p.block_bytes)
    blocks, md5s = _compress(tmp_path, files)
    want_blocks, want_md5s = pe_layout.layout(*files, BLOCK)
    assert md5s == want_md5s and blocks != want_blocks
    assert len(blocks) < len(want_blocks)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_interleave_order_is_the_references(name):
    """Every block pair: the port's interleaved block holds the
    reference's record order, and its deinterleave gives both mates'
    plaintext back."""
    f1, f2 = INPUTS[name]()
    at2 = 0
    for a, b in pe_layout.cut_file1(f1, BLOCK // 2):
        raw1 = f1[a:b]
        end2 = pe_layout.take_records(f2, at2, pe_layout.records_of(raw1))
        raw2, at2 = f2[at2:end2], end2
        b1 = parse_block(raw1, raw1.endswith(b"\n"))
        b2 = parse_block(raw2, raw2.endswith(b"\n"))
        merged = pe.interleave_blocks(b1, b2)
        got = pe_layout.split_records(assemble_block(merged))
        want = pe_layout.interleaved(raw1, raw2)
        # compared without newlines: the coder's block ends as file 2 does
        assert [r.rstrip(b"\n") for r in got] == [
            r.rstrip(b"\n") for r in want]
        d1, d2 = pe.deinterleave_block(merged, b1.final_newline,
                                       b2.final_newline)
        assert assemble_block(d1) == raw1 and assemble_block(d2) == raw2
    assert at2 == len(f2)
