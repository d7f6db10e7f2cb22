"""k-mer hash index build (host only).

Copied from fastqueeze_tpu/align/index.py (RefIndex, build_from_ref): a
counted CSR over the present k-mers — sorted unique keys + prefix offsets
+ positions.  The self-align probe builds one over a block's own reads.
Saving and loading index files (reference-aligned mode) are not ported
yet (ROADMAP Queue A item 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from fastqueeze_tpu_torch.align.ref import RefSeq
from fastqueeze_tpu_torch.config import CodecParams


@dataclass
class RefIndex:
    k: int
    ref_len: int
    ref_md5: str
    keys: np.ndarray       # (S,) sorted distinct k-mer values (u32 or u64)
    offsets: np.ndarray    # (S + 1,) uint64 prefix offsets into positions
    positions: np.ndarray  # (P,) uint32/uint64 k-mer start positions
    packed: np.ndarray     # (ceil(N/16)+1,) uint32 2-bit packed reference
    names: list
    bounds: np.ndarray

    @property
    def n_keys(self) -> int:
        return len(self.keys)

    @property
    def n_positions(self) -> int:
        return len(self.positions)

    @property
    def max_count(self) -> int:
        if not self.n_keys:
            return 0
        return int(np.diff(self.offsets.astype(np.int64)).max())


def _rolling_kmers(codes: np.ndarray, amb: np.ndarray, k: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(N,) codes -> (N-k+1,) k-mer values + validity (no ambiguous base)."""
    n = len(codes)
    P = n - k + 1
    if P <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    dtype = np.uint32 if k <= 15 else np.uint64
    kv = np.zeros(P, dtype)
    for j in range(k):
        kv = (kv << np.uint8(2)) | codes[j:j + P].astype(dtype)
    # window valid iff no ambiguous base inside: prefix-sum trick
    cs = np.zeros(n + 1, np.int64)
    np.cumsum(amb, out=cs[1:])
    valid = (cs[k:] - cs[:-k]) == 0
    return kv, valid


def build_from_ref(ref: RefSeq, params: CodecParams) -> RefIndex:
    from fastqueeze_tpu_torch.io import native
    k = params.seed_len
    r = native.csr_build(ref.codes, ref.amb_mask, k) \
        if ref.length < (1 << 32) else None
    if r is not None:
        # native one-pass: rolling k-mers + stable LSD radix sort
        # (bit-identical arrays to the argsort path below)
        kv_sorted, pos_sorted = r
    else:
        kv, valid = _rolling_kmers(ref.codes, ref.amb_mask, k)
        pos_all = np.flatnonzero(valid)
        kv = kv[pos_all]
        order = np.argsort(kv, kind="stable")
        kv_sorted = kv[order]
        pos_sorted = pos_all[order]
    # run-length over the sorted keys (replaces np.unique: the array is
    # already sorted, one diff pass suffices)
    if len(kv_sorted):
        change = np.empty(len(kv_sorted), bool)
        change[0] = True
        np.not_equal(kv_sorted[1:], kv_sorted[:-1], out=change[1:])
        starts_idx = np.flatnonzero(change)
        keys = kv_sorted[starts_idx]
        counts = np.diff(np.append(starts_idx, len(kv_sorted)))
    else:
        keys = kv_sorted[:0]
        counts = np.zeros(0, np.int64)
    # drop hyper-repetitive seeds (reference caps occurrences @0x4108d0;
    # verification-time candidate caps are separate: seed_max_occ/seed_big_occ)
    keep = counts <= max(params.seed_drop_occ, 1)
    if not keep.all():
        pos_sorted = pos_sorted[np.repeat(keep, counts)]
        keys, counts = keys[keep], counts[keep]
    offsets = np.zeros(len(keys) + 1, np.uint64)
    np.cumsum(counts, out=offsets[1:])
    pos_dtype = np.uint32 if ref.length < (1 << 32) else np.uint64
    return RefIndex(k=k, ref_len=ref.length, ref_md5=ref.md5,
                    keys=keys, offsets=offsets,
                    positions=pos_sorted.astype(pos_dtype),
                    packed=ref.packed(), names=ref.names, bounds=ref.bounds)
