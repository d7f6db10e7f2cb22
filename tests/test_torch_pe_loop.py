"""compress_pe on driver.compress_blocks, compress_se's loop, on the CPU.

The frozen tables train on the records they always trained on, file 1's
first model_train_mb / 2 MB as read_blocks cuts it and the same records
of file 2, now taken from the block pairs that the encode loop reuses:
archives whose training prefix ends inside a block pair, spans several
pairs, takes -l's transform, or is the whole of inputs with mates of
different lengths and a file 2 without its final newline, equal the JAX
package's byte for byte, at -t 1 and -t 2.  Each mate of each block pair
is parsed once; at -t 1 block pair i+1 is read, interleaved and
dispatched before block pair i is finalized; both mates' files and the
stage and pair counts are what they should be.
"""

import numpy as np
import pytest

from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.pipeline import pe as jpe
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import ArcReader
from fastqueeze_tpu_torch.pipeline import blockcodec
from fastqueeze_tpu_torch.pipeline import driver as td
from fastqueeze_tpu_torch.pipeline import pe as tpe
from fastqueeze_tpu_torch.utils.metrics import DebugInfo


def _pairs(n, seed, lens=(100, 100), final_newline=True):
    """Seeded pairs from a small random genome: mate 1 forward, mate 2
    the reverse complement 200-400 bp on, lengths drawn from ``lens``
    (each mate its own), Markov-ish qualities, SRA IDs equal in both
    files; file 2 without its last newline unless ``final_newline``."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 100_000)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = ([], [])
    for r in range(n):
        s = int(rng.integers(0, len(genome) - 600))
        ins = int(rng.integers(200, 400))
        for k in (0, 1):
            L = int(rng.integers(lens[0], lens[1] + 1))
            if k == 0:
                codes = genome[s:s + L]
            else:
                codes = 3 - genome[s + ins - L:s + ins][::-1]
            seq = acgt[codes].copy()
            seq[rng.random(L) < 0.01] = ord("N")
            q = (np.clip(np.cumsum(rng.integers(-1, 2, L)) + 30, 2, 40)
                 + 33).astype(np.uint8)
            out[k].append(b"@SRR0000001.%d %d length=%d\n" % (r + 1, r + 1, L)
                          + seq.tobytes() + b"\n+\n" + q.tobytes() + b"\n")
    r1, r2 = b"".join(out[0]), b"".join(out[1])
    return r1, r2 if final_newline else r2[:-1]


# name: (pairs, read lengths, file 2 ends in a newline, CodecParams fields)
# model_train_mb 1: the prefix is file 1's first 512 KiB, inside block
# pair 2 (200 kB of file 1 a pair); 34 (the default): the whole input
_CASES = {
    "cut_inside_a_pair": (4000, (100, 100), True,
                          dict(use_model=1, model_train_mb=1,
                               block_bytes=400_000)),
    "cut_lossy": (4000, (100, 100), True,
                  dict(use_model=1, model_train_mb=1, block_bytes=400_000,
                       lossy_factor=1.2)),
    "whole_input_varlen": (900, (30, 150), False,
                           dict(use_model=1, block_bytes=60_000)),
    "cut_t2": (4000, (100, 100), True,
               dict(use_model=1, model_train_mb=1, block_bytes=400_000,
                    threads=2)),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pe_loop")
    out = {}
    for name, (n, lens, fnl, _) in _CASES.items():
        paths = (str(d / f"{name}_1.fq"), str(d / f"{name}_2.fq"))
        for path, data in zip(paths, _pairs(n, 31, lens, fnl)):
            with open(path, "wb") as fh:
                fh.write(data)
        out[name] = paths
    return d, out


@pytest.mark.parametrize("name", sorted(_CASES))
def test_archive_equals_the_jax_packages(inputs, name):
    d, paths = inputs[0], inputs[1][name]
    kw = _CASES[name][3]
    tarc, jarc = str(d / f"t_{name}.fqz"), str(d / f"j_{name}.fqz")
    dbg = DebugInfo()
    r = tpe.compress_pe(CodecParams(**kw), *paths, tarc, dbg=dbg,
                        device="cpu")
    jpe.compress_pe(JParams(**kw), *paths, jarc)
    with open(tarc, "rb") as a, open(jarc, "rb") as b:
        assert a.read() == b.read()
    with ArcReader(tarc) as reader:
        n_pairs = sum(b.n_reads for b in reader.blocks)
        assert reader.model_blob is not None
    assert r["blocks"] >= 3
    assert dbg.vals["pairs"] == n_pairs == _CASES[name][0]
    assert dbg.vals["reads"] == 2 * n_pairs
    back = str(d / f"back_{name}")
    td.decompress(tarc, back, device="cpu", force=True)
    for path, suffix in zip(paths, ("_1.fastq", "_2.fastq")):
        with open(path, "rb") as a, open(back + suffix, "rb") as b:
            # -l restores the transformed qualities: same size, new bytes
            same = a.read() == b.read()
            assert same is ("lossy_factor" not in kw)


def test_each_mate_is_parsed_once(inputs, monkeypatch):
    """The training prefix (here the whole input, 3+ block pairs) and
    the encode loop share one parse of each mate of each block pair."""
    d, paths = inputs[0], inputs[1]["whole_input_varlen"]
    parsed = []
    parse = tpe.parse_block

    def counting(raw, fnl=True):
        parsed.append(len(raw))
        return parse(raw, fnl)

    monkeypatch.setattr(tpe, "parse_block", counting)
    dbg = DebugInfo()
    r = tpe.compress_pe(CodecParams(**_CASES["whole_input_varlen"][3]),
                        *paths, str(d / "once.fqz"), dbg=dbg, device="cpu")
    assert r["blocks"] >= 3 and dbg.vals["train_s"] > 0
    assert len(parsed) == 2 * r["blocks"]
    assert sum(parsed) == r["raw"]


def test_the_next_pair_is_dispatched_before_one_is_finalized(inputs,
                                                              monkeypatch):
    """-t 1: block pair i+1's file 2 records, interleave and dispatch all
    come before block pair i's finalize (the SE loop's order)."""
    d, paths = inputs[0], inputs[1]["cut_inside_a_pair"]
    events = []
    take, interleave, job = (tpe._RecordReader.take, tpe.interleave_blocks,
                             blockcodec.encode_block_job)

    def taking(self, n):
        events.append(("take", n))
        return take(self, n)

    def interleaving(b1, b2):
        events.append(("interleave", b1.n_reads))
        return interleave(b1, b2)

    def dispatching(p, block, *a, **kw):
        events.append(("dispatch", block.n_reads // 2))
        fin = job(p, block, *a, **kw)

        def finalize():
            events.append(("finalize", block.n_reads // 2))
            return fin()
        return finalize

    monkeypatch.setattr(tpe._RecordReader, "take", taking)
    monkeypatch.setattr(tpe, "interleave_blocks", interleaving)
    monkeypatch.setattr(td, "encode_block_job", dispatching)
    kw = dict(_CASES["cut_inside_a_pair"][3], use_model=-1, self_align=0)
    r = tpe.compress_pe(CodecParams(**kw), *paths, str(d / "ahead.fqz"),
                        device="cpu")
    kinds = [k for k, _ in events]
    assert kinds.count("dispatch") == kinds.count("finalize") == r["blocks"]
    assert r["blocks"] >= 3
    # per block pair: take, interleave, dispatch, then the previous pair's
    # finalize; the last pair's finalize ends the call
    want = ["take", "interleave", "dispatch"]
    for _ in range(r["blocks"] - 1):
        want += ["take", "interleave", "dispatch", "finalize"]
    assert kinds == want + ["finalize"]
    fins = [n for k, n in events if k == "finalize"]
    assert fins == [n for k, n in events if k == "dispatch"]
