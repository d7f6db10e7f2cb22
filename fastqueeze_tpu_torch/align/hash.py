"""Host side of the seed aligner: the result type and the index arrays.

Copied from fastqueeze_tpu/align/hash.py (AlignResult and the host arrays
the Aligner constructor builds).  The self-align probe feeds these arrays
to the native one-pass aligner (native/alignhost.cpp fq_selfref_align);
the device aligner kernels are not ported yet (ROADMAP Queue B, B11-B14).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from fastqueeze_tpu_torch.align.index import RefIndex
from fastqueeze_tpu_torch.config import CodecParams


class AlignResult(NamedTuple):
    mapped: np.ndarray    # (R,) bool
    pos: np.ndarray       # (R,) int64 window start in ref coords
    is_rev: np.ndarray    # (R,) bool
    mis_mask: np.ndarray  # (R, Lp) bool, True at mismatch (window coords)


class Aligner:
    """CSR index arrays in the layout the native aligner walks."""

    def __init__(self, idx: RefIndex, params: CodecParams):
        if idx.n_positions >= (1 << 31) or idx.ref_len >= (1 << 31):
            raise ValueError("reference too large for a single-chip index")
        if idx.k > 31:
            raise ValueError("aligner supports seed_len <= 31")
        self.params = params
        self.ref_len = idx.ref_len
        self.k = idx.k
        keys = np.asarray(idx.keys, np.uint64)
        if not len(keys):
            keys = np.zeros(1, np.uint64)
        offs = np.asarray(idx.offsets, np.int32)
        if len(offs) < 2:
            offs = np.zeros(2, np.int32)
        pos = np.asarray(idx.positions, np.int32)
        if not len(pos):
            pos = np.zeros(1, np.int32)
        # first-level prefix table: bounds the per-seed binary search to one
        # bucket
        l1_bits = min(2 * self.k, 18)
        self._l1_shift = max(0, 2 * self.k - l1_bits)
        l1 = np.searchsorted(
            keys >> np.uint64(self._l1_shift),
            np.arange((1 << l1_bits) + 1, dtype=np.uint64)).astype(np.int32)
        max_bucket = int(np.diff(l1).max()) if len(l1) > 1 else 1
        self._search_steps = max(1, int(np.ceil(np.log2(max_bucket + 1))))
        self._h_keys = keys
        self._h_offsets = offs
        self._h_positions = pos
        # padded so the native inner loops can fetch up to lp/16 + 1 words
        # past the true end without clamping (masked-out slots only)
        self._h_packed = np.concatenate([idx.packed.astype(np.uint32),
                                         np.zeros(1026, np.uint32)])
        self._h_l1 = l1
