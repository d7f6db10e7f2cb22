"""The plain reference of a paired-end archive's layout.

A paired-end archive (SeqArc's PE format, as the program writes it) holds
the two mate files cut into block pairs: file 1 is cut at record
boundaries every half block, as a reader that takes half a block at a
time and keeps each chunk's whole records cuts it, and file 2 gives each
block pair as many records as file 1 gave.  Each block pair is coded with
its mates interleaved (r1_0, r2_0, r1_1, ...), and the archive's block
table records, per block pair, the pairs, each file's plaintext bytes and
the MD5 of file 1's plaintext followed by file 2's; the archive also
holds each file's whole MD5.

Byte-exact restoration is the ``roundtrip`` reference's to judge.  This
one judges what that check cannot see: the block table and the pairing.
Plain NumPy and Python; it imports nothing of the program.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

NL = 10


@dataclass
class BlockPair:
    n_pairs: int
    raw_len1: int
    raw_len2: int
    md5: bytes


def _newlines(data) -> np.ndarray:
    return np.flatnonzero(np.frombuffer(bytes(data), np.uint8) == NL)


def cut_file1(data, half: int) -> List[Tuple[int, int]]:
    """[start, end) of each block of file 1: chunks of ``half`` bytes are
    read in turn, and each time the bytes held (the chunk after what the
    last cut left) end a whole record, everything up to the last whole
    record is a block; what is left at the end of the file is the last
    block."""
    nl = _newlines(data)
    size, start, held = len(data), 0, 0
    out = []
    while held < size:
        held = min(held + half, size)
        lo, hi = np.searchsorted(nl, [start, held])
        whole = (hi - lo) // 4 * 4
        if whole:
            end = int(nl[lo + whole - 1]) + 1
            out.append((start, end))
            start = end
    if start < size:
        out.append((start, size))
    return out


def records_of(raw) -> int:
    """Whole records in ``raw``; a last record without its newline
    counts."""
    lines = raw.count(b"\n") + (0 if raw.endswith(b"\n") else 1)
    return lines // 4 if raw else 0


def take_records(data, start: int, n: int) -> int:
    """The end of ``n`` records of file 2 from ``start`` (the file's end
    where its last record has no newline)."""
    if n == 0:
        return start
    nl = _newlines(data[start:])
    if len(nl) >= 4 * n:
        return start + int(nl[4 * n - 1]) + 1
    if len(nl) == 4 * n - 1 and not bytes(data).endswith(b"\n"):
        return len(data)
    raise ValueError("file 2 ran out of records")


def layout(file1, file2, block_size: int) -> Tuple[List[BlockPair],
                                                    List[bytes]]:
    """(block pairs, [MD5 of file 1, MD5 of file 2]) of the archive of
    ``file1`` and ``file2`` (bytes) at ``block_size`` bytes a block."""
    f1, f2 = bytes(file1), bytes(file2)
    pairs, at2 = [], 0
    for a, b in cut_file1(f1, block_size // 2):
        raw1 = f1[a:b]
        n = records_of(raw1)
        end2 = take_records(f2, at2, n)
        raw2 = f2[at2:end2]
        at2 = end2
        pairs.append(BlockPair(n, len(raw1), len(raw2),
                               hashlib.md5(raw1 + raw2).digest()))
    if at2 != len(f2):
        raise ValueError("file 2 has records left over")
    return pairs, [hashlib.md5(f1).digest(), hashlib.md5(f2).digest()]


def split_records(raw) -> List[bytes]:
    """The records of ``raw``, each with its newlines (the last one
    without, where ``raw`` has none at its end)."""
    lines = bytes(raw).split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
        tail = True
    else:
        tail = False
    recs = [b"\n".join(lines[i:i + 4]) + b"\n"
            for i in range(0, len(lines), 4)]
    if recs and not tail:
        recs[-1] = recs[-1][:-1]
    return recs


def interleaved(raw1, raw2) -> List[bytes]:
    """The records of a block pair in the order the coder takes them:
    mate 1 of pair 0, mate 2 of pair 0, mate 1 of pair 1, ..."""
    r1, r2 = split_records(raw1), split_records(raw2)
    if len(r1) != len(r2):
        raise ValueError(f"{len(r1)} and {len(r2)} records")
    return [r for pair in zip(r1, r2) for r in pair]
