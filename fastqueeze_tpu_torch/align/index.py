"""k-mer hash index: build / save / load (host only).

Copied from fastqueeze_tpu/align/index.py: a counted CSR over the present
k-mers (sorted unique keys + prefix offsets + positions) instead of the
reference binary's dense 4^k table.  The ``.fqzidx`` file (``-i ref.fa``)
is byte-identical to the JAX package's, and each package loads the
other's.  The aligner (align/hash.py) uploads the arrays to the card once
per reference; lookups there are K8's bucketed binary search.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from fastqueeze_tpu_torch.align.ref import RefSeq, load_fasta
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.encap import iter_tlv, write_tlv

IDX_MAGIC = b"FQZIDX01"
IDX_SUFFIX = ".fqzidx"

_TAG_META = 1
_TAG_KEYS = 2
_TAG_OFFS = 3
_TAG_POS = 4
_TAG_PACK = 5


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


def index_path(fasta_path: str) -> str:
    return fasta_path + IDX_SUFFIX


def save_index(idx: RefIndex, path: str) -> None:
    meta = {
        "k": idx.k, "ref_len": idx.ref_len, "ref_md5": idx.ref_md5,
        "n_keys": idx.n_keys, "n_pos": idx.n_positions,
        "key_dtype": idx.keys.dtype.str, "pos_dtype": idx.positions.dtype.str,
        "names": idx.names, "bounds": idx.bounds.tolist(),
    }
    with open(path, "wb") as fh:
        fh.write(IDX_MAGIC)
        fh.write(write_tlv(_TAG_META, json.dumps(meta).encode()))
        fh.write(write_tlv(_TAG_KEYS, idx.keys.tobytes()))
        fh.write(write_tlv(_TAG_OFFS, idx.offsets.astype("<u8").tobytes()))
        fh.write(write_tlv(_TAG_POS, idx.positions.tobytes()))
        fh.write(write_tlv(_TAG_PACK, idx.packed.astype("<u4").tobytes()))


def load_index_file(path: str, shared: bool = False) -> RefIndex:
    """shared=True maps the file instead of copying (reference parity:
    `-s` stages the index in POSIX shm so concurrent processes share one
    copy, SURVEY.md §2.2 — here the page cache plays that role: every
    process holding the mmap shares the same physical pages)."""
    if shared:
        import mmap
        with open(path, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        if mm[:len(IDX_MAGIC)] != IDX_MAGIC:
            raise ValueError(f"{path}: not a fastqueeze index")
        from fastqueeze_tpu_torch.container.encap import iter_tlv_view
        raw = memoryview(mm)[len(IDX_MAGIC):]
        sections = dict(iter_tlv_view(raw))
        copy = lambda a: a          # noqa: E731  (views into the mapping)
    else:
        with open(path, "rb") as fh:
            if fh.read(len(IDX_MAGIC)) != IDX_MAGIC:
                raise ValueError(f"{path}: not a fastqueeze index")
            raw = fh.read()
        sections = dict(iter_tlv(raw))
        copy = np.copy
    meta = json.loads(bytes(sections[_TAG_META]).decode())
    keys = copy(np.frombuffer(sections[_TAG_KEYS], meta["key_dtype"]))
    offsets = copy(np.frombuffer(sections[_TAG_OFFS], "<u8"))
    positions = copy(np.frombuffer(sections[_TAG_POS], meta["pos_dtype"]))
    packed = copy(np.frombuffer(sections[_TAG_PACK], "<u4"))
    return RefIndex(k=meta["k"], ref_len=meta["ref_len"],
                    ref_md5=meta["ref_md5"], keys=keys, offsets=offsets,
                    positions=positions, packed=packed, names=meta["names"],
                    bounds=np.asarray(meta["bounds"], np.int64))


def build_index(fasta_path: str, params: CodecParams,
                out_path: Optional[str] = None) -> str:
    """CLI `-i ref.fa`: build and persist the index (+ md5 fingerprint)."""
    ref = load_fasta(fasta_path)
    idx = build_from_ref(ref, params)
    out = out_path or index_path(fasta_path)
    save_index(idx, out)
    return out


def load_index(fasta_path: str, params: CodecParams,
               expect_md5: Optional[str] = None) -> Tuple[RefIndex, RefSeq]:
    """Load the on-disk index if present & matching, else rebuild in memory
    (reference behavior: decode without ref.fa.hash rebuilds, SURVEY.md §8).
    A reference whose MD5 disagrees with ``expect_md5`` (from the archive)
    is rejected (reference: "CError: Wrong Ref File")."""
    ref = load_fasta(fasta_path)
    if expect_md5 is not None and ref.md5 != expect_md5:
        raise ValueError(
            f"wrong reference: {fasta_path} md5 {ref.md5} != archive's "
            f"{expect_md5}")
    ipath = index_path(fasta_path)
    if os.path.exists(ipath):
        idx = load_index_file(ipath, shared=bool(params.shm_index))
        if idx.ref_md5 == ref.md5 and idx.k == params.seed_len:
            return idx, ref
    return build_from_ref(ref, params), ref
