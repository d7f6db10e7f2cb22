"""The benchmark's seeded FASTQ generator.

Copied from chip_smoke.py ``_genome_fastq``, ``_markov_quals``,
``_sra_heads`` and ``_pe_fastq`` at commit 754d661 (SRA-style IDs, no
indels; the pairs without the smoke's seedless mates), with the seed
taken from ``--seed`` and the FASTQ assembled in bulk instead of written
record by record.  The bytes of a record are the same as there:
``@SRR0000001.<n> <n> length=<L>``, the read, ``+``, the qualities.

The configuration's ``reads`` group names the kind of input (``KINDS``:
``se``, one file; ``pe``, two files of mates) and its parameters; a key
that the kind does not read is refused, not ignored.

Every parameter comes from the configuration's ``reads`` group and the
mix's read count, so every seed gives the same sizes and only the content
changes.  Each job of a run compresses the seed's records rotated by a
job-specific number of records (:class:`RotatedInput`): the same reads
and sizes in another order, so that no job's file equals another's and
no memo of the program keyed on content (its training and table caches)
carries work from one job to the next, as it cannot for a user who
compresses each file once.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def markov_quals(rng: np.random.Generator, R: int, L: int,
                 states: int) -> np.ndarray:
    """(R, L) Phred+33 qualities from a seeded first-order Markov chain:
    states 0..states-1 = Phred 2..states+1, a band around the current
    value, drifting down along the read."""
    S = states
    P = np.exp(-np.abs(np.arange(S)[None, :] - np.arange(S)[:, None]
                       + 0.6) / 1.5)
    P[:, -1] += 0.02
    P /= P.sum(axis=1, keepdims=True)
    flat = (np.cumsum(P, axis=1) + np.arange(S)[:, None]).ravel()
    st = np.minimum(rng.geometric(0.08, R), S) - 1
    st = S - 1 - st
    q = np.empty((R, L), np.uint8)
    for i in range(L):
        q[:, i] = st
        u = rng.random(R)
        st = np.minimum(np.searchsorted(flat, st + u, side="right") - st * S,
                        S - 1)
    return (q + 2 + 33).astype(np.uint8)


def sra_heads(R: int, L: int) -> list:
    return [b"@SRR0000001.%d %d length=%d\n" % (r + 1, r + 1, L)
            for r in range(R)]


def genome_fastq(seed: int, n_reads: int, reads: Dict) -> np.ndarray:
    """The FASTQ bytes (uint8) of ``n_reads`` reads of ``reads["length"]``
    bp drawn from a random genome of ``reads["genome_bp"]`` bases:
    substitutions at ``reads["sub_rate"]``, N at ``reads["n_rate"]``,
    qualities over ``reads["qual_states"]`` values.  The same seed gives
    the same bytes."""
    if reads.get("ids", "sra") != "sra":
        raise ValueError(f"unknown id style {reads.get('ids')!r}")
    R, L, G = int(n_reads), int(reads["length"]), int(reads["genome_bp"])
    rng = np.random.default_rng(int(seed))
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    starts = rng.integers(0, G - L, R)
    codes = genome[starts[:, None] + np.arange(L)]
    del genome
    sub = rng.random(codes.shape) < float(reads["sub_rate"])
    codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    seq = _ACGT[codes]
    del codes, sub
    seq[rng.random(seq.shape) < float(reads["n_rate"])] = ord("N")
    qual = markov_quals(rng, R, L, int(reads["qual_states"]))
    return assemble(sra_heads(R, L), seq, qual)


def pe_fastq(seed: int, n_pairs: int, reads: Dict) -> List[np.ndarray]:
    """The two FASTQ files (uint8) of ``n_pairs`` pairs of
    ``reads["length"]`` bp from a random genome of ``reads["genome_bp"]``
    bases: mate 1 forward at s, mate 2 the reverse complement ending at
    s + insert (insert uniform in ``reads["insert_min"]``..
    ``reads["insert_max"]``), substitutions and N on both at the rates of
    :func:`genome_fastq`, the same IDs in both files.  The same seed gives
    the same bytes."""
    R, L, G = int(n_pairs), int(reads["length"]), int(reads["genome_bp"])
    lo, hi = int(reads["insert_min"]), int(reads["insert_max"])
    if not L <= lo <= hi < G:
        raise ValueError(f"inserts {lo}..{hi} do not fit reads of {L} bp "
                         f"on a genome of {G}")
    rng = np.random.default_rng(int(seed))
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    s = rng.integers(0, G - hi, R)
    ins = rng.integers(lo, hi + 1, R)
    i = np.arange(L)[None, :]
    m1 = genome[s[:, None] + i]
    m2 = 3 - genome[(s + ins - L)[:, None] + i][:, ::-1]
    del genome
    heads = sra_heads(R, L)
    out = []
    for m in (m1, m2):
        sub = rng.random(m.shape) < float(reads["sub_rate"])
        m[sub] = (m[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        seq = _ACGT[m]
        seq[rng.random(seq.shape) < float(reads["n_rate"])] = ord("N")
        out.append(assemble(heads, seq, markov_quals(
            rng, R, L, int(reads["qual_states"]))))
    return out


_COMMON = {"kind", "length", "genome_bp", "sub_rate", "n_rate",
           "qual_states", "ids"}
# kind: (the generator, the keys of ``reads`` it reads, its files)
KINDS = {
    "se": (lambda seed, n, reads: [genome_fastq(seed, n, reads)],
           _COMMON, 1),
    "pe": (pe_fastq, _COMMON | {"insert_min", "insert_max"}, 2),
}


def files_of(reads: Dict) -> int:
    """The number of files that ``reads``' kind makes; refuses an unknown
    kind or a key that the kind does not read."""
    kind = reads.get("kind")
    if kind not in KINDS:
        raise ValueError(f"reads: unknown kind {kind!r} (have: "
                         f"{', '.join(sorted(KINDS))})")
    extra = set(reads) - KINDS[kind][1]
    if extra:
        raise ValueError(f"reads: keys {sorted(extra)} are not read by "
                         f"kind {kind!r}")
    if reads.get("ids", "sra") != "sra":
        raise ValueError(f"reads: unknown id style {reads.get('ids')!r}")
    return KINDS[kind][2]


def make_files(seed: int, n_reads: int, reads: Dict) -> List[np.ndarray]:
    """The input files of ``reads``' kind: ``n_reads`` records each."""
    files_of(reads)
    return KINDS[reads["kind"]][0](seed, n_reads, reads)


def assemble(heads: list, seq: np.ndarray, qual: np.ndarray) -> np.ndarray:
    """Records ``head + seq + "\\n+\\n" + qual + "\\n"`` of equal-length
    reads, as one read-only uint8 array."""
    R, L = seq.shape
    w = 2 * L + 4
    body = np.empty((R, w), np.uint8)
    body[:, :L] = seq
    body[:, L:L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    body[:, L + 3:2 * L + 3] = qual
    body[:, -1] = ord("\n")
    flat = body.tobytes()
    return np.frombuffer(b"".join([x for r in range(R) for x in (
        heads[r], flat[r * w:(r + 1) * w])]), np.uint8)


# the rotation of job k: k x the golden ratio's fraction of the records
_GOLDEN = 0.6180339887498949


class RotatedInput:
    """The seed's FASTQ files and, for job k, the same records rotated by
    ``record(k)`` records (job 0: not rotated), in every file alike, so
    that mates stay paired."""

    def __init__(self, bases):
        self.bases = [bases] if isinstance(bases, np.ndarray) else list(bases)
        self.starts = []
        for base in self.bases:
            nl = np.flatnonzero(base == ord("\n"))
            if nl.size % 4 or (nl.size and nl[-1] != base.size - 1):
                raise ValueError("not whole 4-line records")
            self.starts.append(np.concatenate([[0], nl[3::4][:-1] + 1]))
        if len({st.size for st in self.starts}) != 1:
            raise ValueError("files with different record counts")
        self.nbytes = int(sum(b.size for b in self.bases))

    def record(self, k: int) -> int:
        return int(self.starts[0].size * ((k * _GOLDEN) % 1.0))

    def offset(self, k: int, f: int = 0) -> int:
        """The byte at which job k's file ``f`` starts in the seed's."""
        return int(self.starts[f][self.record(k)])

    def write(self, paths: List[str], k: int) -> None:
        for f, path in enumerate(paths):
            off, base = self.offset(k, f), self.bases[f]
            with open(path, "wb") as fh:
                fh.write(base[off:])
                fh.write(base[:off])

    def expected(self, k: int, f: int = 0) -> np.ndarray:
        """Job k's file ``f`` as bytes."""
        off, base = self.offset(k, f), self.bases[f]
        return np.concatenate((base[off:], base[:off]))
