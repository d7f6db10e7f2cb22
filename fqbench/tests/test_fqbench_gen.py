"""The seeded generator: the same seed gives the same bytes, other seeds
other bytes of the same size, and every job's rotation is a whole-record
rotation of the seed's file."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import gen, harness  # noqa: E402

READS = {"kind": "se", "length": 100, "genome_bp": 200_000, "sub_rate": 0.01,
         "n_rate": 0.001, "qual_states": 40, "ids": "sra"}


def test_same_seed_same_bytes():
    a = gen.genome_fastq(7, 500, READS)
    b = gen.genome_fastq(7, 500, READS)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("other", [8, 2**31 + 7, 2**33 + 1])
def test_other_seed_other_bytes_same_size(other):
    a = gen.genome_fastq(7, 500, READS)
    b = gen.genome_fastq(other, 500, READS)
    assert a.size == b.size
    assert not np.array_equal(a, b)


def test_records_are_fastq():
    data = gen.genome_fastq(2**31 + 11, 300, READS).tobytes()
    lines = data.split(b"\n")
    assert lines[-1] == b"" and len(lines) == 4 * 300 + 1
    for r in range(300):
        head, seq, plus, qual = lines[4 * r:4 * r + 4]
        assert head == b"@SRR0000001.%d %d length=100" % (r + 1, r + 1)
        assert len(seq) == len(qual) == 100 and plus == b"+"
        assert set(seq) <= set(b"ACGTN")
        assert all(35 <= q <= 35 + 39 for q in qual)


def test_markov_quals_match_the_records():
    rng = np.random.default_rng(3)
    q = gen.markov_quals(rng, 1000, 100, 40)
    assert q.shape == (1000, 100) and q.min() >= 35 and q.max() <= 74
    # a band around the current value: most steps move by a few values
    assert np.mean(np.abs(np.diff(q.astype(int), axis=1)) <= 3) > 0.9


def test_rotations_are_distinct_whole_records(tmp_path):
    inp = gen.RotatedInput(gen.genome_fastq(5, 400, READS))
    offs = [inp.offset(k) for k in range(30)]
    assert offs[0] == 0 and len(set(offs)) == 30
    for k in (0, 1, 9):
        path = tmp_path / f"in{k}.fq"
        inp.write([str(path)], k)
        got = np.fromfile(path, np.uint8)
        assert np.array_equal(got, inp.expected(k))
        assert got[0] == ord("@") and got.size == inp.nbytes
        # the same records, in another order
        assert sorted(_records(got)) == sorted(_records(inp.bases[0]))


def _records(data: np.ndarray) -> list:
    lines = data.tobytes().split(b"\n")[:-1]
    return [tuple(lines[i:i + 4]) for i in range(0, len(lines), 4)]


def test_cell_inputs_have_the_configured_size():
    """Each cell's mix and generator give every seed the same size."""
    for name in ("se_default.roundtrip", "se_q3.roundtrip"):
        cell = harness.load_cell(name)
        assert cell.mix["reads_per_file"] == 400_000
        assert cell.config["reads"]["length"] == 100
        assert gen.files_of(cell.config["reads"]) == 1


PE = dict(READS, kind="pe", insert_min=200, insert_max=500)


def test_pairs_same_seed_same_bytes_other_seed_other_bytes():
    a, b = gen.make_files(7, 300, PE), gen.make_files(7, 300, PE)
    c = gen.make_files(2**31 + 7, 300, PE)
    assert len(a) == 2 and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [x.size for x in a] == [x.size for x in c]
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))


def test_mates_are_paired_and_rotate_together(tmp_path):
    one, two = gen.make_files(2**31 + 3, 300, PE)
    r1, r2 = _records(one), _records(two)
    assert [r[0] for r in r1] == [r[0] for r in r2]
    inp = gen.RotatedInput([one, two])
    paths = [str(tmp_path / "a.fq"), str(tmp_path / "b.fq")]
    inp.write(paths, 5)
    got = [_records(np.fromfile(p, np.uint8)) for p in paths]
    assert [r[0] for r in got[0]] == [r[0] for r in got[1]]
    assert got[0][0][0] != r1[0][0]
    assert inp.nbytes == one.size + two.size


def test_mate_two_is_the_reverse_complement_ending_at_the_insert():
    """Without errors and with an insert of 150 bp, mate 2 reverse-
    complemented starts 50 bp into mate 1: their halves overlap."""
    clean = dict(PE, sub_rate=0.0, n_rate=0.0, genome_bp=5_000,
                 insert_min=150, insert_max=150)
    one, two = gen.make_files(11, 50, clean)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for (h1, s1, _, _), (h2, s2, _, _) in zip(_records(one), _records(two)):
        assert h1 == h2
        rc = s2.translate(comp)[::-1]
        assert len(rc) == len(s1) == 100 and s1[50:] == rc[:50]


@pytest.mark.parametrize("reads, match", [
    (dict(READS, kind="long"), "unknown kind"),
    (dict(READS, insert_min=200), "not read by kind"),
    (dict(READS, ids="illumina"), "unknown id style"),
])
def test_reads_the_generator_cannot_make_are_refused(reads, match):
    with pytest.raises(ValueError, match=match):
        gen.make_files(1, 10, reads)
