"""FASTQ block reader/parser/assembler.

Capability parity with the reference's reader thread + record machinery
(SURVEY.md C5 srcfile:SeqArcRead.cpp: gzread + cultbuf record-boundary
cutting; C7 getBlockRead parsing into per-stream arrays).  The hot paths are
vectorized numpy over the raw byte buffer rather than per-record loops; a
C++ scanner can slot in behind the same interface.

A *block* is a contiguous run of whole records totalling ~block_size_mb of
plaintext; blocks are the unit of (de)compression and parallelism.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

NL = 10  # ord("\n")


class LazyLines:
    """List-of-bytes view over (concatenated bytes, line offsets).

    The SE encode path only ever needs the concatenated form (the ID
    binner tokenizes over one flat buffer) — materializing R small bytes
    objects per block costs real time on this 1-vCPU host, so it happens
    lazily, on first element access.  `cat`/`offs` are the fast path."""

    __slots__ = ("cat", "offs", "_list")

    def __init__(self, cat: bytes, offs: np.ndarray):
        self.cat = cat                  # concatenated line bytes
        self.offs = offs                # (R+1,) int64 boundaries
        self._list = None

    def _mat(self) -> List[bytes]:
        if self._list is None:
            cat, o = self.cat, self.offs.tolist()
            self._list = [cat[o[i]:o[i + 1]] for i in range(len(o) - 1)]
        return self._list

    def __len__(self):
        return len(self.offs) - 1

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, k):
        return self._mat()[k]

    def __eq__(self, other):
        return list(self) == list(other)

    def has_content(self) -> bool:
        return len(self.cat) > 0


def any_content(lines) -> bool:
    """any(lines) without materializing a LazyLines."""
    if isinstance(lines, LazyLines):
        return lines.has_content()
    return any(lines)


def open_maybe_gz(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb"), True
    return open(path, "rb"), False


@dataclass
class FastqBlock:
    """SoA view of one block of FASTQ records.

    ids/plus are *lines without* their leading '@'/'+' and trailing newline.
    seq/qual are concatenated byte arrays with per-read lengths.
    """

    n_reads: int
    ids: List[bytes]
    plus: List[bytes]              # content after '+' (usually empty)
    seq_flat: np.ndarray           # uint8, concatenated bases
    qual_flat: np.ndarray          # uint8, concatenated raw quality chars
    lengths: np.ndarray            # (R,) int64 per-read length
    raw_len: int                   # plaintext bytes of this block
    final_newline: bool = True     # False only for a last block w/o trailing \n


def _line_spans(buf: np.ndarray, missing_final_nl: bool):
    """(starts, ends) of lines in buf (ends exclude the newline)."""
    nl_pos = np.flatnonzero(buf == NL)
    if missing_final_nl:
        nl_pos = np.append(nl_pos, len(buf))
    ends = nl_pos
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = nl_pos[:-1] + 1
    return starts, ends


def _extract_concat(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Concatenate buf[starts[i]:ends[i]] slices, vectorized."""
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.uint8), lens
    idx = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens) + np.repeat(starts, lens)
    return buf[idx], lens


def _lazy_lines(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                R: int) -> LazyLines:
    from fastqueeze_tpu_torch.io import native
    lens = (ends - starts).astype(np.int64)
    offs = np.zeros(R + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    total = int(offs[-1])
    cat = native.gather(buf, starts, ends, total)
    if cat is None:
        cat, _ = _extract_concat(buf, starts.astype(np.int64),
                                 ends.astype(np.int64))
    return LazyLines(cat.tobytes(), offs)


def parse_block(raw: bytes, final_newline: bool = True) -> FastqBlock:
    """Parse whole-record FASTQ bytes into SoA form.

    Uses the native C++ scanner (io/native.py -> native/fqscan.cpp) when
    available — one pass over the buffer — else vectorized numpy."""
    buf = np.frombuffer(raw, np.uint8)
    from fastqueeze_tpu_torch.io import native
    spans = native.parse_spans(buf, not final_newline)
    if spans is not None:
        sp, R = spans
        seq_lens = (sp["sq_e"] - sp["sq_s"]).astype(np.int64)
        total = int(seq_lens.sum())
        seq_flat = native.gather(buf, sp["sq_s"], sp["sq_e"], total)
        qual_flat = native.gather(buf, sp["qu_s"], sp["qu_e"], total)
        ids = _lazy_lines(buf, sp["id_s"], sp["id_e"], R)
        plus = _lazy_lines(buf, sp["pl_s"], sp["pl_e"], R)
        return FastqBlock(n_reads=R, ids=ids, plus=plus, seq_flat=seq_flat,
                          qual_flat=qual_flat, lengths=seq_lens,
                          raw_len=len(raw), final_newline=final_newline)
    starts, ends = _line_spans(buf, not final_newline)
    nlines = len(starts)
    if nlines % 4:
        raise ValueError(f"FASTQ block has {nlines} lines (not divisible by 4)")
    R = nlines // 4
    id_s, id_e = starts[0::4], ends[0::4]
    sq_s, sq_e = starts[1::4], ends[1::4]
    pl_s, pl_e = starts[2::4], ends[2::4]
    qu_s, qu_e = starts[3::4], ends[3::4]
    if not (buf[id_s] == ord("@")).all():
        bad = int(np.flatnonzero(buf[id_s] != ord("@"))[0])
        raise ValueError(f"record {bad}: ID line does not start with '@'")
    if not (buf[pl_s] == ord("+")).all():
        raise ValueError("malformed FASTQ: '+' line missing")
    seq_flat, seq_lens = _extract_concat(buf, sq_s, sq_e)
    qual_flat, qual_lens = _extract_concat(buf, qu_s, qu_e)
    if not np.array_equal(seq_lens, qual_lens):
        raise ValueError("seq/qual length mismatch")
    ids = [raw[s + 1:e] for s, e in zip(id_s.tolist(), id_e.tolist())]
    plus = [raw[s + 1:e] for s, e in zip(pl_s.tolist(), pl_e.tolist())]
    return FastqBlock(n_reads=R, ids=ids, plus=plus, seq_flat=seq_flat,
                      qual_flat=qual_flat, lengths=seq_lens.astype(np.int64),
                      raw_len=len(raw), final_newline=final_newline)


def _line_lens(lines, R: int) -> np.ndarray:
    if isinstance(lines, LazyLines):
        return np.diff(lines.offs)
    return np.fromiter((len(x) for x in lines), np.int64, R)


def _line_cat(lines) -> bytes:
    if isinstance(lines, LazyLines):
        return lines.cat
    return b"".join(lines)


def assemble_block(block: FastqBlock) -> bytes:
    """Inverse of parse_block: rebuild the exact plaintext bytes."""
    R = block.n_reads
    id_lens = _line_lens(block.ids, R)
    pl_lens = _line_lens(block.plus, R)
    lens = block.lengths
    rec_lens = id_lens + pl_lens + 2 * lens + 6  # '@' + '+' + 4x'\n'
    total = int(rec_lens.sum())
    out = np.empty(total, np.uint8)
    rec_off = np.cumsum(rec_lens) - rec_lens

    # id lines
    out[rec_off] = ord("@")
    _scatter_concat(out, rec_off + 1, id_lens,
                    np.frombuffer(_line_cat(block.ids), np.uint8))
    p = rec_off + 1 + id_lens
    out[p] = NL
    # seq
    _scatter_concat(out, p + 1, lens, block.seq_flat)
    p = p + 1 + lens
    out[p] = NL
    # plus
    out[p + 1] = ord("+")
    _scatter_concat(out, p + 2, pl_lens,
                    np.frombuffer(_line_cat(block.plus), np.uint8))
    p = p + 2 + pl_lens
    out[p] = NL
    # qual
    _scatter_concat(out, p + 1, lens, block.qual_flat)
    p = p + 1 + lens
    out[p] = NL
    raw = out.tobytes()
    if not block.final_newline:
        raw = raw[:-1]
    return raw


def _scatter_concat(out: np.ndarray, dest_starts: np.ndarray,
                    lens: np.ndarray, flat: np.ndarray) -> None:
    total = int(lens.sum())
    if total == 0:
        return
    from fastqueeze_tpu_torch.io import native
    if native.scatter(flat, dest_starts, lens, out):
        return
    idx = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens) + np.repeat(dest_starts, lens)
    out[idx] = flat


def read_blocks(path: str, block_size: int) -> Iterator[Tuple[bytes, bool]]:
    """Yield (raw_block_bytes, final_newline) of whole records, ~block_size
    each (reference: 50 MB cut at record boundaries, cultbuf)."""
    fh, _ = open_maybe_gz(path)
    carry = b""
    with fh:
        while True:
            chunk = fh.read(block_size)
            if not chunk:
                if carry:
                    yield _finish(carry)
                return
            data = carry + chunk
            cut = _record_boundary(data)
            if cut == 0:
                carry = data
                continue
            yield data[:cut], True
            carry = data[cut:]


def _finish(data: bytes) -> Tuple[bytes, bool]:
    return (data, True) if data.endswith(b"\n") else (data, False)


def _record_boundary(data: bytes) -> int:
    """Largest offset that ends a whole number of 4-line records
    (reference: cultbuf, SURVEY.md C5)."""
    from fastqueeze_tpu_torch.io import native
    nb = native.record_boundary(data)
    if nb is not None:
        return nb
    buf = np.frombuffer(data, np.uint8)
    nl_pos = np.flatnonzero(buf == NL)
    n_complete = (len(nl_pos) // 4) * 4
    if n_complete == 0:
        return 0
    return int(nl_pos[n_complete - 1]) + 1
