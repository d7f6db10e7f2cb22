"""Reference FASTA loading and 2-bit packing (host only).

Copied from fastqueeze_tpu/align/ref.py: all chromosomes are concatenated
into one global coordinate space (names + boundaries kept for metadata);
bases are 2-bit codes packed MSB-first into uint32 words (16 bases/word)
so an arbitrary-offset window is two words + a funnel shift, the unit the
aligner kernels (K8, K9) compare.  The MD5 of the FASTA file's bytes goes
into PARAM and rejects a wrong reference at decode time.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

import numpy as np

# ACGT/acgt -> 0..3 (reference: nst_nt4_table @0x44b800); everything else is
# ambiguous and maps to code 0 with amb_mask set (windows containing it are
# never indexed, and mapped reads never contain degenerate bases, so the
# substitution is invisible to the round-trip).
_CODE_MAP = np.zeros(256, np.uint8)
_AMB_MAP = np.ones(256, bool)
for _i, _cs in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
    for _c in _cs:
        _CODE_MAP[_c] = _i
        _AMB_MAP[_c] = False


@dataclass
class RefSeq:
    codes: np.ndarray        # (N,) uint8 2-bit codes, chroms concatenated
    amb_mask: np.ndarray     # (N,) bool, True where the base was not ACGT
    names: List[str]         # chromosome names
    bounds: np.ndarray       # (n_chrom + 1,) int64 cumulative offsets
    md5: str                 # hex MD5 of the FASTA file bytes

    @property
    def length(self) -> int:
        return len(self.codes)

    def packed(self) -> np.ndarray:
        return pack_2bit(self.codes)


def load_fasta(path: str) -> RefSeq:
    md5 = hashlib.md5()
    names: List[str] = []
    chunks: List[np.ndarray] = []
    lens: List[int] = []
    cur: List[bytes] = []

    def flush():
        if names:
            seq = b"".join(cur)
            buf = np.frombuffer(seq, np.uint8)
            chunks.append(buf)
            lens.append(len(buf))
        cur.clear()

    with open(path, "rb") as fh:
        for line in fh:
            md5.update(line)
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                flush()
                names.append(line[1:].split()[0].decode("latin-1"))
            else:
                if not names:
                    raise ValueError(f"{path}: not FASTA (no '>' header)")
                cur.append(line)
    flush()
    if not names:
        raise ValueError(f"{path}: empty FASTA")
    raw = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    codes = _CODE_MAP[raw]
    amb = _AMB_MAP[raw]
    bounds = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=bounds[1:])
    return RefSeq(codes=codes, amb_mask=amb, names=names, bounds=bounds,
                  md5=md5.hexdigest())


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """(N,) 2-bit codes -> (ceil(N/16)+1,) uint32, MSB-first per word.

    Base j sits at bits [2*(15 - j%16) .. +1] of word j//16.  One zero pad
    word is appended so window fetches may always read word w0+1.
    """
    n = len(codes)
    W = (n + 15) // 16
    padded = np.zeros(W * 16, np.uint8)
    padded[:n] = codes
    lanes = padded.reshape(W, 16).astype(np.uint32)
    shifts = (2 * (15 - np.arange(16, dtype=np.uint32)))[None, :]
    words = (lanes << shifts).sum(axis=1, dtype=np.uint32)
    return np.concatenate([words, np.zeros(1, np.uint32)])
