"""Reference sequence container and 2-bit packing (host only).

Copied from fastqueeze_tpu/align/ref.py: the self-align probe builds a
RefSeq from a block's own reads.  FASTA loading (reference-aligned mode)
is not ported yet (ROADMAP Queue A item 8).

Bases are 2-bit codes packed MSB-first into uint32 words (16 bases/word).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


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
