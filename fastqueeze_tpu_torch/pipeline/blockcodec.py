"""Per-block stream split + entropy coding (single-end).

Copied from fastqueeze_tpu/pipeline/blockcodec.py (SE encode_block_job /
decode_block): a block of parsed records is split into independently
coded streams — lengths, read IDs (binned), plus lines, duplicate-read
back-references, degenerate (non-ACGT) bases, 2-bit sequence, quality —
each wrapped in a TLV section.  The two big streams (seq, qual) go to the
wave-rANS coder on the engine's device: frozen when the archive has
trained tables (adapting from them with frozen_adapt), adaptive
otherwise.  Every other stream of at most
``host_stream_max`` symbols goes to the native host range coder (marker
2); longer ones go to the adaptive wave-rANS coder (marker 1).

Reference-aligned and self-referential blocks add the alignment streams:
per-read mapped flags, and for the mapped reads window start, strand,
mismatch counts, positions and substituted bases (context = the reference
base), plus the indel CIGAR streams and the PE ``-I`` insert deltas.  Not
ported yet: the long-read chunk streams (ROADMAP Queue A item 8).
"""

from __future__ import annotations

import io
import json
from typing import Dict, List, Optional

import numpy as np

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.encap import iter_tlv, write_tlv
from fastqueeze_tpu_torch.io.fastq import FastqBlock
from fastqueeze_tpu_torch.models.base import (
    FlatModel, byte_model, flag_model, qual_model_for, seq_model_from_params)
from fastqueeze_tpu_torch.ops import host_adapt, host_frozen, host_rans
from fastqueeze_tpu_torch.ops.engine import (
    decode_stream, decode_stream_job, encode_stream, encode_stream_job)
from fastqueeze_tpu_torch.pipeline.frozen import (
    device_raw_tables, device_tables, frozen_host_cums, qual_lut, qual_vocab)
from fastqueeze_tpu_torch.pipeline.idproc import (
    IdBinSchema, analyze_ids, reconstruct_ids)

TAG_META = 1
TAG_LEN = 2
TAG_DEGCNT = 3
TAG_DEGPOS = 4
TAG_DEGCHR = 5
TAG_IDSCHEMA = 6
TAG_IDVAR = 7
TAG_IDRAW = 8
TAG_PLUSSCHEMA = 9
TAG_PLUSVAR = 10
TAG_PLUSRAW = 11
TAG_SEQ = 12
TAG_QUAL = 13
TAG_SDUPF = 25    # duplicate tier: per-read seq-duplicate flag
TAG_SDUPD = 26    # seq-dup reads: back-distance (in reads) to the first
                  #   identical earlier read
TAG_QDUPF = 27    # duplicate tier: per-read qual-duplicate flag
TAG_QDUPD = 28    # qual-dup reads: back-distance to the first identical
TAG_AMAP = 14     # per-read mapped flag
TAG_APOS = 15     # mapped: window start position bytes
TAG_AREV = 16     # mapped: reverse-complement flag
TAG_AMISC = 17    # mapped: mismatch count per read
TAG_AMISP = 18    # mapped: mismatch positions (window coords, delta)
TAG_AMISB = 19    # mapped: substituted bases (2-bit), ctx = ref base
TAG_APDF = 20     # PE -I: delta-coded flag per eligible mate-2
TAG_APD = 21      # PE -I: zigzag insert deltas for flagged mate-2s
TAG_ACIGF = 22    # mapped: has-indel flag
TAG_ACIGS = 23    # indel reads: split position s in the read
TAG_ACIGL = 24    # indel reads: zigzag signed gap size g
TAG_ACG2F = 29    # indel reads: has-second-op flag
TAG_ACG2S = 30    # 2-op reads: second split position s2 (>= s1 + |g1<0|)
TAG_ACG2L = 31    # 2-op reads: zigzag signed second gap g2
TAG_LRF = 32      # first tag of the long-read chunk streams (32-45)

_VAR_CHUNK = 256  # var byte streams are cut into pseudo-reads for lanes
_LR_MSG = ("long-read chunk streams (reads over align_max_len): ROADMAP "
           "Queue A item 8")

_BASE_MAP = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE_MAP[_c] = _i
_BASE_INV = np.frombuffer(b"ACGT", np.uint8)


# --- duplicate-read tier (CodecParams.dedup) ---------------------------
# A read byte-identical to an earlier read of the same block is coded as a
# back-reference: flag + distance (in reads) to its FIRST identical earlier
# occurrence.  Sequence and quality are deduplicated independently (PCR
# duplicates share the sequence but not the qualities).  Sources are by
# construction non-duplicates themselves, so decode restores every
# duplicate with one vectorized gather after the unique reads are filled.

_HASH_W = np.zeros(0, np.uint64)


def _row_hash_weights(L: int) -> np.ndarray:
    """Per-byte-position u64 weights: splitmix64(i + 1) | 1.  A pure
    function of the position, identical in numpy and native/duphash.cpp
    (dup decisions must match across backends/threads/processes:
    -t N ≡ -t 1 payload invariance and the native/numpy twin invariant)."""
    global _HASH_W
    if len(_HASH_W) < L:
        i = np.arange(1, L + 1, dtype=np.uint64)
        z = i * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        _HASH_W = (z ^ (z >> np.uint64(31))) | np.uint64(1)
    return _HASH_W[:L]


def _dup_group(mat: np.ndarray, rows: np.ndarray, src: np.ndarray) -> bool:
    """mat: (n, L) uint8 rows (same length); rows: their block read
    indices (ascending).  Writes first-occurrence indices into src for
    verified duplicates; returns True if any were found."""
    n, L = mat.shape
    h = (mat.astype(np.uint64) * _row_hash_weights(L)[None, :]).sum(
        axis=1, dtype=np.uint64)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = hs[1:] != hs[:-1]
    n_groups = int(new.sum())
    if n_groups == n:
        return False
    gid = np.cumsum(new) - 1
    first = np.full(n_groups, n, np.int64)
    np.minimum.at(first, gid, order)
    cand = np.empty(n, np.int64)
    cand[order] = first[gid]
    dup = cand < np.arange(n)
    d = np.flatnonzero(dup)
    if not len(d):
        return False
    # verify content equality (hash collisions: the colliding read simply
    # stays unique — never a wrong back-reference)
    eq = (mat[d] == mat[cand[d]]).all(axis=1)
    d = d[eq]
    if not len(d):
        return False
    src[rows[d]] = rows[cand[d]]
    return True


def _dup_sources(flat: np.ndarray, lengths: np.ndarray):
    """Per-read index of the first identical earlier read (same length,
    same bytes), or -1.  None when the block has no duplicates.  Native
    one-pass (native/duphash.cpp) with this numpy mirror as fallback —
    bit-identical results (same weights, grouping, and verify rule)."""
    R = len(lengths)
    if R < 2:
        return None
    from fastqueeze_tpu_torch.io import native
    out = native.dup_sources(flat, lengths)
    if out is not None:
        src, n_found = out
        return src if n_found else None
    return _dup_sources_np(flat, lengths)


def _dup_sources_np(flat: np.ndarray, lengths: np.ndarray):
    R = len(lengths)
    src = np.full(R, -1, np.int64)
    offs = np.cumsum(lengths) - lengths
    found = False
    uls = np.unique(lengths)
    for L in uls.tolist():
        if L <= 0:
            continue
        if len(uls) == 1:
            rows = np.arange(R)
            mat = flat[:R * L].reshape(R, L)      # no gather: one length
        else:
            rows = np.flatnonzero(lengths == L)
            if len(rows) < 2:
                continue
            idx = offs[rows][:, None] + np.arange(L, dtype=np.int64)[None, :]
            mat = flat[idx]
        if len(rows) >= 2 and _dup_group(mat, rows, src):
            found = True
    return src if found else None


def dup_masks(block: FastqBlock):
    """(seq_src, qual_src) duplicate back-references for a block, cached on
    the block object (the driver precomputes them for training blocks)."""
    cached = getattr(block, "_dup_masks", None)
    if cached is None:
        cached = (_dup_sources(block.seq_flat, block.lengths),
                  _dup_sources(block.qual_flat, block.lengths))
        block._dup_masks = cached
    return cached


def dedup_training_block(block: FastqBlock, p: CodecParams):
    """(training_block, kept_sym_fraction): `block` with qual-duplicate
    reads removed, chunked at block size — the duplicate tier codes each
    block independently, so a multi-block training prefix must dedup per
    block-sized chunk, not across the whole prefix.  Feeding the trainer
    the deduped sample keeps the qctx cost model honest: the in-sample
    projection (proj = max(est, sample)) otherwise counts duplicate
    symbols the coder will never emit and over-buys big tables."""
    R = block.n_reads
    if not p.dedup or R < 2:
        return block, 1.0
    bs = p.block_bytes or p.block_size_mb * (1 << 20)
    if block.raw_len and block.raw_len > bs:
        n_chunk = max(2, int(R * bs / block.raw_len))
        keep = np.ones(R, bool)
        offs = np.cumsum(block.lengths) - block.lengths
        for s in range(0, R, n_chunk):
            e = min(s + n_chunk, R)
            lo = int(offs[s])
            hi = int(offs[e - 1] + block.lengths[e - 1])
            q = _dup_sources(block.qual_flat[lo:hi], block.lengths[s:e])
            if q is not None:
                keep[s:e] = q < 0
    else:
        _, q = dup_masks(block)      # real block: reuse the cached masks
        if q is None:
            return block, 1.0
        keep = q < 0
    if keep.all():
        return block, 1.0
    sym = np.repeat(keep, block.lengths)
    tb = FastqBlock(
        n_reads=int(keep.sum()), ids=[], plus=[],
        seq_flat=block.seq_flat[sym], qual_flat=block.qual_flat[sym],
        lengths=block.lengths[keep], raw_len=0, final_newline=True)
    frac = int(tb.lengths.sum()) / max(int(block.lengths.sum()), 1)
    return tb, frac


def _intra_of(lens: np.ndarray) -> np.ndarray:
    """Per-symbol position-within-read for concatenated reads of lens."""
    offs = np.cumsum(lens) - lens
    return (np.arange(int(lens.sum()), dtype=np.int64)
            - np.repeat(offs, lens))


def _copy_read_ranges(arr: np.ndarray, src_off: np.ndarray,
                      dst_off: np.ndarray, lens: np.ndarray) -> None:
    """arr[dst_off[i]:+lens[i]] = arr[src_off[i]:+lens[i]] for all i —
    the duplicate-restore copy.  Native gather+scatter when available
    (the numpy fallback pays two big index vectors)."""
    total = int(lens.sum())
    if total == 0:
        return
    from fastqueeze_tpu_torch.io import native
    g = native.gather(arr, src_off, src_off + lens, total)
    if g is not None:
        native.scatter(g, dst_off, lens, arr)
        return
    intra = _intra_of(lens)
    arr[np.repeat(dst_off, lens) + intra] = \
        arr[np.repeat(src_off, lens) + intra]


def _chunk_counts(n: int, chunk: int = _VAR_CHUNK) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int64)
    full, rem = divmod(n, chunk)
    counts = [chunk] * full + ([rem] if rem else [])
    return np.asarray(counts, np.int64)


def _code_bytes(p: CodecParams, raw: bytes, device,
                order1: bool = True) -> bytes:
    """Entropy-code a host byte string.  Marker dispatch: 0 = stored raw,
    1 = adaptive wave-rANS on ``device``, 2 = host range coder."""
    if not raw:
        return b"\x00"
    flat = np.frombuffer(raw, np.uint8)
    if len(flat) <= p.host_stream_max:
        if order1:
            blob = host_rans.encode_o1(flat, 256, p.byte_init, p.byte_inc,
                                       p.byte_cap)
        else:
            blob = host_rans.encode_ctx(flat, None, 1, 256, p.byte_init,
                                        p.byte_inc, p.byte_cap)
        payload = b"\x02" + len(raw).to_bytes(4, "little") + blob
    else:
        payload = (b"\x01" + len(raw).to_bytes(4, "little")
                   + encode_stream(byte_model(p, order1), p, flat,
                                   _chunk_counts(len(raw)), adapt=True,
                                   device=device))
    if len(payload) >= len(raw) + 1:
        return b"\x00" + raw
    return payload


def _marker(blob: bytes) -> bytes:
    """Stream marker: 1 = adaptive wave-rANS, 2 = host range coder;
    anything else is corruption."""
    if blob[:1] not in (b"\x01", b"\x02"):
        raise ValueError("corrupt block payload: unknown stream marker")
    return blob[:1]


def _decode_bytes(p: CodecParams, blob: bytes, device,
                  order1: bool = True) -> bytes:
    if blob[:1] == b"\x00":
        return blob[1:]
    marker = _marker(blob)
    n = int.from_bytes(blob[1:5], "little")
    if marker == b"\x01":
        flat = decode_stream(byte_model(p, order1), p, blob[5:],
                             _chunk_counts(n), adapt=True, device=device)
    elif order1:
        flat = host_rans.decode_o1(blob[5:], n, 256, p.byte_init,
                                   p.byte_inc, p.byte_cap)
    else:
        flat = host_rans.decode_ctx(blob[5:], n, None, 1, 256,
                                    p.byte_init, p.byte_inc, p.byte_cap)
    return flat.astype(np.uint8).tobytes()


def _code_lines(p: CodecParams, lines, R: int, device) -> bytes:
    """Fallback line coder for IDs/plus lines when binning fails
    (reference: encode_name @0x421070, SURVEY.md §2.1 path 2).  Codes the
    lines through the tokenized previous-name diff coder (marker 3) and
    through the generic byte path; the smaller payload wins, so
    unstructured IDs (SRA hashes, instrument coords) land near entropy
    while degenerate inputs keep the raw/order-1 floor."""
    from fastqueeze_tpu_torch.io.fastq import LazyLines
    if R == 0:
        return _code_bytes(p, b"", device)
    if isinstance(lines, LazyLines):
        cat = np.frombuffer(lines.cat, np.uint8)
        lens = np.diff(lines.offs).astype(np.int32)
    else:
        cat = np.frombuffer(b"".join(lines), np.uint8)
        lens = np.array([len(x) for x in lines], np.int32)
    blob = host_rans.encode_names(cat, lens, p.byte_init, p.byte_inc,
                                  p.byte_cap)
    cand = b"\x03" + len(cat).to_bytes(4, "little") + blob
    alt = _code_bytes(p, b"\n".join(lines) + b"\n", device)
    return cand if len(cand) < len(alt) else alt


def _decode_lines(p: CodecParams, blob: bytes, R: int,
                  device) -> List[bytes]:
    if blob[:1] == b"\x03":
        total = int.from_bytes(blob[1:5], "little")
        cat, lens = host_rans.decode_names(blob[5:], R, total, p.byte_init,
                                           p.byte_inc, p.byte_cap)
        offs = np.concatenate(([0], np.cumsum(lens, dtype=np.int64)))
        c = cat.tobytes()
        return [c[offs[i]:offs[i + 1]] for i in range(R)]
    raw = _decode_bytes(p, blob, device)
    return raw.split(b"\n")[:-1] if raw else []


def _qual_alphabet(qmax: int) -> int:
    return ((qmax + 1 + 7) // 8) * 8


def _width_of(max_val: int) -> int:
    """Byte width tier for little-endian integer streams (the reference's
    encode_len_short/encode_len_long split, generalized to 1/2/4)."""
    if max_val <= 0xFF:
        return 1
    if max_val <= 0xFFFF:
        return 2
    return 4


def _code_flags(p: CodecParams, bits: np.ndarray, device) -> bytes:
    """Entropy-code a boolean vector through an adaptive binary model
    (marker 1 = wave-rANS on ``device``, 2 = host order-1)."""
    b8 = bits.astype(np.uint8)
    if len(bits) <= p.host_stream_max:
        return b"\x02" + host_rans.encode_o1(b8, 2, p.byte_init, p.byte_inc,
                                             p.byte_cap)
    return b"\x01" + encode_stream(flag_model(p), p, b8,
                                   _chunk_counts(len(bits)), adapt=True,
                                   device=device)


def _decode_flags(p: CodecParams, blob: bytes, n: int,
                  device) -> np.ndarray:
    if _marker(blob) == b"\x02":
        return host_rans.decode_o1(blob[1:], n, 2, p.byte_init, p.byte_inc,
                                   p.byte_cap).astype(bool)
    return decode_stream(flag_model(p), p, blob[1:], _chunk_counts(n),
                         adapt=True, device=device).astype(bool)


def _le_byte_stream(values: np.ndarray, nbytes: int):
    """values -> per-item little-endian bytes, ctx = byte index."""
    n = len(values)
    syms = np.empty(n * nbytes, np.uint8)
    for b in range(nbytes):
        syms[b::nbytes] = (values >> (8 * b)) & 0xFF
    ctx = np.tile(np.arange(nbytes, dtype=np.uint8), n)
    return syms, ctx


def _from_le_bytes(syms: np.ndarray, n: int, nbytes: int) -> np.ndarray:
    vals = np.zeros(n, np.int64)
    for b in range(nbytes):
        vals |= syms[b::nbytes].astype(np.int64) << (8 * b)
    return vals


def _flat_model(p: CodecParams, n_ctx: int, alphabet: int) -> FlatModel:
    return FlatModel(alphabet=alphabet, init=p.byte_init, inc=p.byte_inc,
                     cap=p.byte_cap, n_ctx=n_ctx)


def _code_syms_ctx(p: CodecParams, syms: np.ndarray, ctx: np.ndarray,
                   n_ctx: int, alphabet: int, device,
                   counts: Optional[np.ndarray] = None) -> bytes:
    """Symbol stream with precomputed per-symbol contexts (marker 2: host
    range coder; marker 1: adaptive wave-rANS over ``counts`` pseudo-reads,
    _VAR_CHUNK-symbol chunks by default)."""
    if len(syms) <= p.host_stream_max:
        return b"\x02" + host_rans.encode_ctx(
            syms, ctx.astype(np.uint32), n_ctx, alphabet, p.byte_init,
            p.byte_inc, p.byte_cap)
    if counts is None:
        counts = _chunk_counts(len(syms))
    return b"\x01" + encode_stream(_flat_model(p, n_ctx, alphabet), p, syms,
                                   counts, adapt=True, device=device,
                                   extra_aux={"ctx": ctx})


def _decode_syms_ctx(p: CodecParams, blob: bytes, n: int, ctx: np.ndarray,
                     n_ctx: int, alphabet: int, device,
                     counts: Optional[np.ndarray] = None) -> np.ndarray:
    if _marker(blob) == b"\x02":
        return host_rans.decode_ctx(blob[1:], n, ctx.astype(np.uint32),
                                    n_ctx, alphabet, p.byte_init,
                                    p.byte_inc, p.byte_cap)
    if counts is None:
        counts = _chunk_counts(n)
    return decode_stream(_flat_model(p, n_ctx, alphabet), p, blob[1:],
                         counts, adapt=True, device=device,
                         extra_aux={"ctx": ctx})


def _code_le(p: CodecParams, values: np.ndarray, nbytes: int,
             device) -> bytes:
    syms, ctx = _le_byte_stream(values.astype(np.int64), nbytes)
    return _code_syms_ctx(p, syms, ctx, nbytes, 256, device,
                          counts=np.full(len(values), nbytes, np.int64))


def _decode_le(p: CodecParams, blob: bytes, n: int, nbytes: int,
               device) -> np.ndarray:
    ctx = np.tile(np.arange(nbytes, dtype=np.uint8), n)
    syms = _decode_syms_ctx(p, blob, n * nbytes, ctx, nbytes, 256, device,
                            counts=np.full(n, nbytes, np.int64))
    return _from_le_bytes(syms, n, nbytes)


def _stream_jobs(p: CodecParams, frozen: Optional[Dict], device, seq, qual,
                 decode: bool = False):
    """Dispatch the seq and qual streams, each (model, symbols or payload,
    per-read counts): frozen against ``frozen``'s tables, adaptive from a
    fresh table when it is None, or adaptive from its raw counts with
    frozen_adapt.  Frozen streams go to the native host coder where
    host_frozen.route says so and fresh adaptive ones where host_adapt.route
    does (bit-identical either way); frozen_adapt streams have no native
    coder (as in the reference) and always take ``device``.  Returns the
    two jobs."""
    jobs = [None, None]
    adapt = frozen is None or bool(p.frozen_adapt)
    tables = (None, None)
    if not adapt:
        routed = [host_frozen.route(p, m, device) for m, _, _ in (seq, qual)]
        if any(routed):
            cums = frozen_host_cums(frozen, qual[0].alphabet,
                                    p.qctx_eff_init())
            for i, (m, data, counts) in enumerate((seq, qual)):
                if routed[i]:
                    job = (host_frozen.decode_job if decode
                           else host_frozen.encode_job)
                    jobs[i] = job(m, p, data, counts, cums[i])
        if None in jobs:
            tables = device_tables(frozen, qual[0].alphabet,
                                   p.qctx_eff_init(), device)
    elif frozen is None:
        for i, (m, data, counts) in enumerate((seq, qual)):
            if host_adapt.route(p, m, device):
                job = (host_adapt.decode_job if decode
                       else host_adapt.encode_job)
                jobs[i] = job(m, p, data, counts)
    else:
        tables = device_raw_tables(frozen, qual[0].alphabet,
                                   p.qctx_eff_init(), device)
    for i, (m, data, counts) in enumerate((seq, qual)):
        if jobs[i] is None:
            job = decode_stream_job if decode else encode_stream_job
            jobs[i] = job(m, p, data, counts, counts0=tables[i],
                          adapt=adapt, device=device)
    return jobs


def encode_block(p: CodecParams, block: FastqBlock,
                 frozen: Optional[Dict], device, dbg=None, align=None,
                 ref_codes: Optional[np.ndarray] = None,
                 self_ref: bool = False) -> bytes:
    return encode_block_job(p, block, frozen, device, dbg, align, ref_codes,
                            self_ref)()


def encode_block_job(p: CodecParams, block: FastqBlock,
                     frozen: Optional[Dict], device, dbg=None, align=None,
                     ref_codes: Optional[np.ndarray] = None,
                     self_ref: bool = False):
    """Dispatch phase of encode_block: the seq and qual streams are queued
    on the device (frozen against ``frozen``'s trained tables, or
    adaptive when ``frozen`` is None) and the host streams coded; the
    returned thunk syncs the device and assembles the block TLV, so a
    driver keeps the next block's host work running while the device
    codes this one.  align: AlignResult over the block's reads (None =
    entropy-only); ref_codes: the reference's 2-bit codes (required with
    align); self_ref: ref_codes is the block's own unmapped reads
    (pipeline/selfref.py), which decode rebuilds."""
    R = block.n_reads
    lengths = block.lengths
    out = io.BytesIO()

    # --- duplicate-read tier: seq/qual back-references to the first
    #     identical earlier read in this block (CodecParams.dedup) ---
    sdup = qdup = None
    s_src = q_src = None
    if p.dedup and R > 1:
        s_src, q_src = dup_masks(block)
    if s_src is not None:
        sdup = s_src >= 0
    if q_src is not None:
        qdup = q_src >= 0
    n_sd = int(sdup.sum()) if sdup is not None else 0
    n_qd = int(qdup.sum()) if qdup is not None else 0
    sdup_sym = np.repeat(sdup, lengths) if n_sd else None

    # --- degenerate (non-ACGT) bases ---
    codes = _BASE_MAP[block.seq_flat]
    dege_mask = codes == 255
    if n_sd:
        # a seq-dup read is restored by copying its source read wholesale;
        # its degenerate bases must not double-code
        dege_mask &= ~sdup_sym
    n_dege = int(dege_mask.sum())
    dege_cnt = np.zeros(R, np.int64)
    dege_pos = np.zeros(0, np.int64)       # in-read positions of dege bases
    if n_dege:
        read_starts = np.cumsum(lengths) - lengths
        dege_idx = np.flatnonzero(dege_mask)
        dege_read = np.searchsorted(read_starts, dege_idx, side="right") - 1
        dege_pos = dege_idx - read_starts[dege_read]
        dege_cnt = np.bincount(dege_read, minlength=R).astype(np.int64)

    # --- quality vocabulary (dense rank coding): with trained tables the
    #     rank space is theirs and values unseen in training get fresh
    #     ranks appended (fit_qual_alphabet pads the frozen table with
    #     init rows); otherwise the block's own values ---
    block_qvals, _ = qual_vocab(block.qual_flat)   # validates char range
    if frozen is not None:
        base = np.asarray(frozen["qvals"], np.uint8)
        extra = np.setdiff1d(block_qvals, base)
        qvals = np.concatenate([base, extra]) if len(extra) else base
    else:
        qvals = block_qvals
    qsyms = qual_lut(qvals)[block.qual_flat]
    qmax = max(len(qvals) - 1, 0)

    mapped = align.mapped if align is not None else np.zeros(R, bool)
    if n_sd:
        # dedup beats the aligned streams on cost (a back-distance vs
        # pos+rev+mis streams); a read that is both stays a duplicate
        mapped = mapped & ~sdup
    n_mapped = int(mapped.sum())

    const_len = int(lengths[0]) if R and (lengths == lengths[0]).all() else None
    meta = {
        "R": R,
        "clen": const_len,
        "fnl": block.final_newline,
        "qmax": qmax,
        "qv": qvals.tolist(),
        "nd": n_dege,
        "nm": n_mapped,
    }
    if self_ref and n_mapped:
        meta["sref"] = 1

    # --- dispatch the big device streams first (seq + qual); host streams
    #     are coded while the device crunches, then the jobs are finalized
    seq_keep = ~mapped & ~sdup if n_sd else ~mapped
    seq_counts = (lengths - dege_cnt)[seq_keep]
    seq_sel = ~dege_mask
    if n_mapped:
        seq_sel &= ~np.repeat(mapped, lengths)
    if n_sd:
        seq_sel &= ~sdup_sym
    seq_syms = codes[seq_sel]
    if n_qd:
        qsyms = qsyms[np.repeat(~qdup, lengths)]
        qlens = lengths[~qdup]
    else:
        qlens = lengths
    seq_model = seq_model_from_params(p)
    qmodel = qual_model_for(p, _qual_alphabet(qmax))
    seq_job, qual_job = _stream_jobs(
        p, frozen, device, (seq_model, seq_syms, seq_counts),
        (qmodel, qsyms, qlens))

    # --- lengths (reference: encode_len_short/encode_len_long, SURVEY.md
    #     §2.1 — variable-width tiers; long reads (ONT/PacBio) take the
    #     4-byte tier instead of hard-failing) ---
    len_payload = None
    if const_len is None and R:
        lenb = _width_of(int(lengths.max()))
        if lenb != 2:
            meta["lenb"] = lenb
        len_payload = _code_le(p, lengths, lenb, device)

    # --- IDs (host binning) ---
    schema, var_payload = analyze_ids(block.ids)
    id_sections = []
    if schema is not None:
        id_sections.append((TAG_IDSCHEMA, schema.to_json()))
        if var_payload:
            id_sections.append((TAG_IDVAR,
                                _code_bytes(p, var_payload, device)))
    else:
        id_sections.append((TAG_IDRAW, _code_lines(p, block.ids, R, device)))

    # --- plus lines ---
    from fastqueeze_tpu_torch.io.fastq import any_content
    plus_sections = []
    if any_content(block.plus):
        pschema, pvar = analyze_ids(block.plus)
        if pschema is not None:
            plus_sections.append((TAG_PLUSSCHEMA, pschema.to_json()))
            if pvar:
                plus_sections.append((TAG_PLUSVAR,
                                      _code_bytes(p, pvar, device)))
        else:
            plus_sections.append((TAG_PLUSRAW,
                                  _code_lines(p, block.plus, R, device)))

    # --- duplicate-tier streams ---
    def _dup_dist(d):
        """Distance payload: absolute or consecutive-delta (zigzag),
        whichever codes smaller — replicated inputs give near-constant
        distances whose deltas are ~all zero."""
        w_abs = _width_of(int(d.max()))
        pay_abs = _code_le(p, d, w_abs, device)
        zz = _zigzag(np.diff(d, prepend=0))
        w_dl = _width_of(int(zz.max()))
        pay_dl = _code_le(p, zz, w_dl, device)
        if len(pay_dl) < len(pay_abs):
            return pay_dl, w_dl, 1
        return pay_abs, w_abs, 0

    dup_sections = []
    if n_sd:
        pay, w, dl = _dup_dist((np.arange(R, dtype=np.int64) - s_src)[sdup])
        meta["nsd"] = n_sd
        meta["sdb"] = w
        if dl:
            meta["sdd"] = 1
        dup_sections += [(TAG_SDUPF, _code_flags(p, sdup, device)),
                         (TAG_SDUPD, pay)]
    if n_qd:
        pay, w, dl = _dup_dist((np.arange(R, dtype=np.int64) - q_src)[qdup])
        meta["nqd"] = n_qd
        meta["qdb"] = w
        if dl:
            meta["qdd"] = 1
        dup_sections += [(TAG_QDUPF, _code_flags(p, qdup, device)),
                         (TAG_QDUPD, pay)]

    # --- degenerate streams ---
    dege_sections = []
    if n_dege:
        if int(dege_cnt.max()) > 0xFF:
            meta["degcb"] = _width_of(int(dege_cnt.max()))
            cnt_payload = _code_le(p, dege_cnt, meta["degcb"], device)
        else:
            cnt_payload = _code_bytes(
                p, dege_cnt.astype(np.uint8).tobytes(), device, order1=False)
        degpb = _width_of(int(dege_pos.max()) if len(dege_pos) else 0)
        degpb = max(degpb, 2)       # 2 is the historical default width
        if degpb != 2:
            meta["degpb"] = degpb
        pos_payload = _code_le(p, dege_pos, degpb, device)
        chr_payload = _code_bytes(
            p, block.seq_flat[dege_mask].tobytes(), device, order1=False)
        dege_sections = [(TAG_DEGCNT, cnt_payload), (TAG_DEGPOS, pos_payload),
                         (TAG_DEGCHR, chr_payload)]

    # --- alignment streams ---
    align_sections = []
    if n_mapped:
        if ref_codes is None:
            raise ValueError("aligned encode needs the reference codes")
        align_sections = _encode_align_streams(p, block, align, ref_codes,
                                               mapped, meta, device)
    if align is not None:
        align_sections.insert(0, (TAG_AMAP, _code_flags(p, mapped, device)))

    def finalize() -> bytes:
        # --- collect the device streams, assemble TLV ---
        seq_payload = seq_job.finalize()
        qual_payload = qual_job.finalize()
        out.write(write_tlv(TAG_META, json.dumps(meta).encode()))
        if len_payload is not None:
            out.write(write_tlv(TAG_LEN, len_payload))
        for tag, payload in (dup_sections + dege_sections + id_sections
                             + plus_sections + align_sections):
            out.write(write_tlv(tag, payload))
        out.write(write_tlv(TAG_SEQ, seq_payload))
        out.write(write_tlv(TAG_QUAL, qual_payload))
        if dbg is not None:
            # per-stream size table
            nsym = int(lengths.sum())
            dbg.add("sz_seq", len(seq_payload))
            dbg.add("sz_qual", len(qual_payload))
            dbg.add("sz_len", len(len_payload) if len_payload else 0)
            dbg.add("sz_id", sum(len(x) for _, x in id_sections))
            dbg.add("sz_plus", sum(len(x) for _, x in plus_sections))
            dbg.add("sz_dege", sum(len(x) for _, x in dege_sections))
            dbg.add("sz_align", sum(len(x) for _, x in align_sections))
            dbg.add("sz_dup", sum(len(x) for _, x in dup_sections))
            dbg.add("dup_seq_reads", n_sd)
            dbg.add("dup_qual_reads", n_qd)
            dbg.add("raw_seq", nsym)
            dbg.add("raw_qual", nsym)
        return out.getvalue()

    return finalize


def _zigzag(v: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, 2 * v, -2 * v - 1)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    return np.where(z % 2 == 0, z // 2, -((z + 1) // 2))


def _encode_align_streams(p: CodecParams, block: FastqBlock, align,
                          ref_codes: np.ndarray, mapped: np.ndarray,
                          meta: Dict, device) -> list:
    """Mapped reads -> pos / rev / mis-count / mis-pos / mis-char streams,
    the PE -I insert-delta streams and the indel CIGAR streams."""
    lengths = block.lengths
    mlens = lengths[mapped]
    posb = max(1, (int(ref_codes.size).bit_length() + 7) // 8)
    mposb = _width_of(int(mlens.max()) if len(mlens) else 0)
    meta["posb"] = posb
    meta["mposb"] = mposb

    pos = align.pos[mapped]
    rev = align.is_rev[mapped]
    mm = align.mis_mask[mapped]                      # (M, lp) window coords
    mis_cnt = mm.sum(axis=1).astype(np.int64)

    # PE -I: a mapped mate-2 whose mate-1 mapped within max_insr is coded
    # as a zigzag delta off mate-1's position
    pe_sections = []
    abs_mask_m = np.ones(len(pos), bool)     # mapped reads coded absolutely
    R = block.n_reads
    if p.is_pe and p.max_insr > 0 and R:
        idx = np.arange(R)
        m1_mapped = np.zeros(R, bool)
        m1_mapped[1::2] = mapped[0::2]
        cand = mapped & (idx % 2 == 1) & m1_mapped
        pos1_of = np.zeros(R, np.int64)
        pos1_of[1::2] = align.pos[0::2]
        delta = align.pos - pos1_of
        ok = cand & (np.abs(delta) <= p.max_insr)
        if cand.any():
            cand_m = cand[mapped]
            ok_m = ok[mapped]
            pe_sections.append((TAG_APDF, _code_flags(p, ok_m[cand_m],
                                                      device)))
            if ok.any():
                insb = max(1, (int(2 * p.max_insr + 1).bit_length() + 7)
                           // 8)
                meta["insb"] = insb
                pe_sections.append((TAG_APD, _code_le(p, _zigzag(delta[ok]),
                                                      insb, device)))
            abs_mask_m = ~ok_m
    meta["nabs"] = int(abs_mask_m.sum())
    if mis_cnt.max(initial=0) > 255:
        raise ValueError(">255 mismatches in one read")

    # mismatch (read, window-col) pairs, row-major = per-read ascending;
    # delta within read (first mismatch absolute)
    rows, cols = np.nonzero(mm)
    prev = np.empty_like(cols)
    prev[0:1] = 0
    prev[1:] = cols[:-1]
    first = np.empty(len(rows), bool)
    first[0:1] = True
    first[1:] = rows[1:] != rows[:-1]
    deltas = np.where(first, cols, cols - prev)

    # indel ops: split s + signed gap g per flagged read, plus an optional
    # second op (s2, g2); mismatches stay in spliced-window coords
    g_m = s_m = g2_m = s2_m = None
    if align.gap_len is not None:
        g_all = align.gap_len[mapped].astype(np.int64)
        if (g_all != 0).any():
            g_m = g_all
            s_m = align.gap_pos[mapped].astype(np.int64)
            if align.gap_len2 is not None and (align.gap_len2 != 0).any():
                g2_m = align.gap_len2[mapped].astype(np.int64)
                s2_m = align.gap_pos2[mapped].astype(np.int64)

    # substituted base = effective-strand read base at the window col;
    # context = the spliced reference base it replaced (filler 0 under
    # insertions), exactly as decode builds the window
    moffs = (np.cumsum(lengths) - lengths)[mapped]
    eff_col = np.where(rev[rows], mlens[rows] - 1 - cols, cols)
    read_base = _BASE_MAP[block.seq_flat[moffs[rows] + eff_col]]
    sub_base = np.where(rev[rows], 3 - read_base, read_base).astype(np.uint8)
    if g_m is None:
        # self-ref windows may overhang the reference end by up to max_mis
        # force-masked bases: clip like the decode-side window build
        ref_base = ref_codes[np.clip(pos[rows] + cols, 0,
                                     max(ref_codes.size - 1, 0))]
    else:
        shift = np.where(cols >= s_m[rows], g_m[rows], 0)
        ins = ((g_m[rows] < 0) & (cols >= s_m[rows])
               & (cols < s_m[rows] - g_m[rows]))
        if g2_m is not None:
            shift = shift + np.where(cols >= s2_m[rows], g2_m[rows], 0)
            ins |= ((g2_m[rows] < 0) & (cols >= s2_m[rows])
                    & (cols < s2_m[rows] - g2_m[rows]))
        ridx = np.clip(pos[rows] + cols + shift, 0, ref_codes.size - 1)
        ref_base = np.where(ins, 0, ref_codes[ridx])

    sections = pe_sections + [
        (TAG_APOS, _code_le(p, pos[abs_mask_m], posb, device)),
        (TAG_AREV, _code_flags(p, rev, device)),
        (TAG_AMISC, _code_bytes(p, mis_cnt.astype(np.uint8).tobytes(),
                                device, order1=False)),
    ]
    if len(rows):
        sections.append((TAG_AMISP, _code_le(p, deltas, mposb, device)))
        sections.append((TAG_AMISB, _code_syms_ctx(
            p, sub_base, ref_base.astype(np.uint8), 4, 4, device)))
    if g_m is not None:
        has = g_m != 0
        meta["nidl"] = int(has.sum())
        gb = 1 if p.max_indel <= 127 else 2   # zigzag range is 2*max_indel
        sections.append((TAG_ACIGF, _code_flags(p, has, device)))
        sections.append((TAG_ACIGS, _code_le(p, s_m[has], mposb, device)))
        sections.append((TAG_ACIGL, _code_le(p, _zigzag(g_m[has]), gb,
                                             device)))
        if g2_m is not None and (g2_m[has] != 0).any():
            # second op streams, nested under the indel reads (the second
            # pass only extends a first-pass indel: g2 != 0 => g1 != 0)
            has2 = g2_m[has] != 0
            meta["nidl2"] = int(has2.sum())
            sections.append((TAG_ACG2F, _code_flags(p, has2, device)))
            sections.append((TAG_ACG2S, _code_le(p, s2_m[has][has2], mposb,
                                                 device)))
            sections.append((TAG_ACG2L, _code_le(
                p, _zigzag(g2_m[has][has2]), gb, device)))
    return sections


def decode_block(p: CodecParams, payload: bytes, frozen: Optional[Dict],
                 device, ref_codes: Optional[np.ndarray] = None) -> FastqBlock:
    """Decode one block payload on ``device`` (ref_codes: the reference's
    2-bit codes, for reference-aligned archives).  Any structural damage a
    corrupt payload can cause downstream (bad lengths -> out-of-range
    indexing, mangled meta JSON, impossible stream sizes) is converted to
    ValueError — the whole-block MD5 then reports it like every other
    corruption path."""
    try:
        return _decode_block_impl(p, payload, frozen, device, ref_codes)
    except ValueError:
        raise
    except (IndexError, KeyError, OverflowError, TypeError,
            json.JSONDecodeError) as e:
        raise ValueError(f"corrupt block payload: {e!r}") from e


def _decode_block_impl(p: CodecParams, payload: bytes,
                       frozen: Optional[Dict], device,
                       ref_codes: Optional[np.ndarray]) -> FastqBlock:
    sections = dict(iter_tlv(payload))
    meta = json.loads(sections[TAG_META].decode())
    R = meta["R"]
    n_dege = meta["nd"]
    qmax = meta["qmax"]
    n_mapped = meta.get("nm", 0)
    self_ref = bool(meta.get("sref", 0))
    if meta.get("lrm", 0) or TAG_LRF in sections:
        raise NotImplementedError(_LR_MSG)
    if n_mapped and ref_codes is None and not self_ref:
        raise ValueError("archive was reference-aligned: decode needs the "
                         "reference FASTA")

    # --- lengths ---
    if meta["clen"] is not None:
        lengths = np.full(R, meta["clen"], np.int64)
    elif R:
        lengths = _decode_le(p, sections[TAG_LEN], R, meta.get("lenb", 2),
                             device)
    else:
        lengths = np.zeros(0, np.int64)
    if R and (lengths.min() < 0 or int(lengths.sum()) > (1 << 33)):
        raise ValueError("corrupt block payload: implausible read lengths")

    # --- degenerate streams ---
    dege_cnt = np.zeros(R, np.int64)
    if n_dege:
        if "degcb" in meta:
            dege_cnt = _decode_le(p, sections[TAG_DEGCNT], R, meta["degcb"],
                                  device)
        else:
            cnt_raw = _decode_bytes(p, sections[TAG_DEGCNT], device,
                                    order1=False)
            dege_cnt = np.frombuffer(cnt_raw, np.uint8).astype(np.int64)
        dpos = _decode_le(p, sections[TAG_DEGPOS], n_dege,
                          meta.get("degpb", 2), device)
        dchr = np.frombuffer(
            _decode_bytes(p, sections[TAG_DEGCHR], device,
                          order1=False), np.uint8)

    # --- map flags ---
    mapped = np.zeros(R, bool)
    if TAG_AMAP in sections:
        mapped = _decode_flags(p, sections[TAG_AMAP], R, device)
    if int(mapped.sum()) != n_mapped:
        raise ValueError("corrupt block payload: mapped count")

    # --- duplicate-tier back-references ---
    def _dup_refs(tag_f, tag_d, n_dup, width, delta):
        flags = _decode_flags(p, sections[tag_f], R, device)
        rows = np.flatnonzero(flags)
        if len(rows) != n_dup:
            raise ValueError("corrupt block payload: dup flag count")
        d = _decode_le(p, sections[tag_d], n_dup, width, device)
        if delta:
            d = np.cumsum(_unzigzag(d))
        src = rows - d
        if ((d <= 0).any() or (src < 0).any() or flags[src].any()
                or (lengths[src] != lengths[rows]).any()):
            raise ValueError("corrupt block payload: bad dup back-refs")
        return flags, rows, src

    n_sd = meta.get("nsd", 0)
    n_qd = meta.get("nqd", 0)
    sdup = np.zeros(R, bool)
    if n_sd:
        sdup, sd_rows, sd_src = _dup_refs(TAG_SDUPF, TAG_SDUPD, n_sd,
                                          meta["sdb"], meta.get("sdd", 0))
    qdup = np.zeros(R, bool)
    if n_qd:
        qdup, qd_rows, qd_src = _dup_refs(TAG_QDUPF, TAG_QDUPD, n_qd,
                                          meta["qdb"], meta.get("qdd", 0))

    # --- dispatch device streams (seq + qual), then do host work ---
    seq_counts = (lengths - dege_cnt)[~mapped & ~sdup]
    qlens = lengths[~qdup] if n_qd else lengths
    seq_model = seq_model_from_params(p)
    qmodel = qual_model_for(p, _qual_alphabet(qmax))
    seq_job, qual_job = _stream_jobs(
        p, frozen, device, (seq_model, sections[TAG_SEQ], seq_counts),
        (qmodel, sections[TAG_QUAL], qlens), decode=True)

    # --- sequence assembly (host) ---
    seq_flat = np.empty(int(lengths.sum()), np.uint8)
    read_off = np.cumsum(lengths) - lengths
    fill = np.zeros(len(seq_flat), bool)   # True where a byte is written
    if n_dege:
        dege_abs = np.repeat(read_off, dege_cnt) + dpos
        seq_flat[dege_abs] = dchr
        fill[dege_abs] = True
    if n_mapped:
        fill |= np.repeat(mapped, lengths)
    if n_sd:
        fill |= np.repeat(sdup, lengths)
    acgt = seq_job.finalize()
    seq_flat[~fill] = _BASE_INV[acgt]
    if n_mapped:
        if self_ref:
            # rebuild the block's self-reference from the (now filled)
            # unmapped reads, exactly as the encoder built it
            from fastqueeze_tpu_torch.pipeline.selfref import ref_eligible
            rows = np.flatnonzero(ref_eligible(mapped, sdup, dege_cnt,
                                               lengths, p.seed_len))
            lr = lengths[rows]
            sel = np.repeat(read_off[rows], lr) + _intra_of(lr)
            # clip: eligible reads are ACGT in valid archives; corrupt
            # payloads must not drive out-of-range model contexts
            ref_codes = np.minimum(_BASE_MAP[seq_flat[sel]], 3)
        _decode_align_streams(p, sections, meta, mapped, lengths, read_off,
                              ref_codes, seq_flat, device)
    if n_sd:
        # duplicate reads: one range copy from their (non-duplicate,
        # already filled) first occurrences
        _copy_read_ranges(seq_flat, read_off[sd_src], read_off[sd_rows],
                          lengths[sd_rows])

    # --- quality (ranks -> phred values via the block's vocabulary) ---
    qsyms = qual_job.finalize()
    if "qv" in meta and len(meta["qv"]):
        qv_chars = np.asarray(meta["qv"], np.uint8) + 33
        # clamp: a corrupt stream can decode the alphabet's round-up
        # padding ranks — garbage bytes here get caught by the block MD5
        qvals_dec = qv_chars[np.minimum(qsyms, len(qv_chars) - 1)]
    else:
        qvals_dec = (qsyms.astype(np.uint8) + 33)
    if n_qd:
        from fastqueeze_tpu_torch.io import native
        qual_flat = np.empty(len(seq_flat), np.uint8)
        # unique reads' quals land at their read offsets (contiguous per
        # read), then duplicates copy from their first occurrences
        if not native.scatter(qvals_dec, read_off[~qdup], qlens, qual_flat):
            qual_flat[~np.repeat(qdup, lengths)] = qvals_dec
        _copy_read_ranges(qual_flat, read_off[qd_src], read_off[qd_rows],
                          lengths[qd_rows])
    else:
        qual_flat = qvals_dec

    # --- IDs ---
    if TAG_IDSCHEMA in sections:
        schema = IdBinSchema.from_json(sections[TAG_IDSCHEMA])
        var = (_decode_bytes(p, sections[TAG_IDVAR], device)
               if TAG_IDVAR in sections else b"")
        ids = reconstruct_ids(schema, R, var)
    else:
        ids = _decode_lines(p, sections[TAG_IDRAW], R, device)

    # --- plus lines ---
    if TAG_PLUSSCHEMA in sections:
        pschema = IdBinSchema.from_json(sections[TAG_PLUSSCHEMA])
        pvar = (_decode_bytes(p, sections[TAG_PLUSVAR], device)
                if TAG_PLUSVAR in sections else b"")
        plus = reconstruct_ids(pschema, R, pvar)
    elif TAG_PLUSRAW in sections:
        plus = _decode_lines(p, sections[TAG_PLUSRAW], R, device)
    else:
        plus = [b""] * R

    def _tot(lines):
        cat = getattr(lines, "cat", None)
        return len(cat) if cat is not None else sum(len(x) for x in lines)

    raw_len = (int(lengths.sum()) * 2 + _tot(ids) + _tot(plus) + 6 * R
               - (0 if meta["fnl"] else 1))
    return FastqBlock(n_reads=R, ids=ids, plus=plus, seq_flat=seq_flat,
                      qual_flat=qual_flat, lengths=lengths, raw_len=raw_len,
                      final_newline=meta["fnl"])


def _decode_align_streams(p: CodecParams, sections: Dict, meta: Dict,
                          mapped: np.ndarray, lengths: np.ndarray,
                          read_off: np.ndarray, ref_codes: np.ndarray,
                          seq_flat: np.ndarray, device) -> None:
    """Reconstruct the mapped reads from the reference (window fetch,
    indel splice, mismatch patches, reverse complement), writing ACGT
    bytes into seq_flat in place."""
    M = int(mapped.sum())
    posb, mposb = meta["posb"], meta["mposb"]
    mlens = lengths[mapped]
    moffs = read_off[mapped]
    pos_abs = _decode_le(p, sections[TAG_APOS], meta.get("nabs", M), posb,
                         device)
    if TAG_APDF in sections:
        # PE -I: delta-coded mate-2 positions off mate-1's
        R = len(mapped)
        idx = np.arange(R)
        m1_mapped = np.zeros(R, bool)
        m1_mapped[1::2] = mapped[0::2]
        cand = mapped & (idx % 2 == 1) & m1_mapped
        cand_m = cand[mapped]
        ok_m = np.zeros(M, bool)
        ok_m[cand_m] = _decode_flags(p, sections[TAG_APDF],
                                     int(cand_m.sum()), device)
        m_idx = np.flatnonzero(mapped)
        pos_r = np.zeros(R, np.int64)
        pos_r[m_idx[~ok_m]] = pos_abs
        n_delta = int(ok_m.sum())
        if n_delta:
            zz = _decode_le(p, sections[TAG_APD], n_delta, meta["insb"],
                            device)
            ok_reads = m_idx[ok_m]
            pos_r[ok_reads] = pos_r[ok_reads - 1] + _unzigzag(zz)
        pos = pos_r[mapped]
    else:
        pos = pos_abs
    rev = _decode_flags(p, sections[TAG_AREV], M, device)
    cnt_raw = _decode_bytes(p, sections[TAG_AMISC], device, order1=False)
    mis_cnt = np.frombuffer(cnt_raw, np.uint8).astype(np.int64)
    n_mis = int(mis_cnt.sum())

    total = int(mlens.sum())
    win_off = np.cumsum(mlens) - mlens
    sym_read = np.repeat(np.arange(M), mlens)
    intra = np.arange(total, dtype=np.int64) - np.repeat(win_off, mlens)
    if TAG_ACIGF in sections:
        # indel reads: spliced window -- ref[pos+i] for i < s, then
        # ref[pos+g+i]; filler 0 over inserted read bases (their values
        # arrive through the mismatch patches); a second op (s2, g2)
        # applies the cumulative shift g+g2 past s2
        g_r, s_r, g2_r, s2_r = (np.zeros(M, np.int64) for _ in range(4))
        has = _decode_flags(p, sections[TAG_ACIGF], M, device)
        nidl = int(has.sum())
        gb = 1 if p.max_indel <= 127 else 2
        if nidl:
            s_r[has] = _decode_le(p, sections[TAG_ACIGS], nidl, mposb,
                                  device)
            g_r[has] = _unzigzag(_decode_le(p, sections[TAG_ACIGL], nidl,
                                            gb, device))
            if TAG_ACG2F in sections:
                has2_i = _decode_flags(p, sections[TAG_ACG2F], nidl, device)
                nidl2 = int(has2_i.sum())
                has2 = np.zeros(M, bool)
                has2[np.flatnonzero(has)[has2_i]] = True
                s2_r[has2] = _decode_le(p, sections[TAG_ACG2S], nidl2,
                                        mposb, device)
                g2_r[has2] = _unzigzag(_decode_le(p, sections[TAG_ACG2L],
                                                  nidl2, gb, device))
        g_sym, s_sym = g_r[sym_read], s_r[sym_read]
        g2_sym, s2_sym = g2_r[sym_read], s2_r[sym_read]
        shift = (np.where(intra >= s_sym, g_sym, 0)
                 + np.where(intra >= s2_sym, g2_sym, 0))
        widx = np.clip(np.repeat(pos, mlens) + intra + shift, 0,
                       ref_codes.size - 1)
        win = ref_codes[widx].copy()
        win[((g_sym < 0) & (intra >= s_sym) & (intra < s_sym - g_sym))
            | ((g2_sym < 0) & (intra >= s2_sym)
               & (intra < s2_sym - g2_sym))] = 0
    else:
        # clip: self-ref windows may overhang the reference edges by up to
        # max_mis bases (every clipped base is patched)
        win = ref_codes[np.clip(np.repeat(pos, mlens) + intra, 0,
                                max(ref_codes.size - 1, 0))].copy()

    if n_mis:
        deltas = _decode_le(p, sections[TAG_AMISP], n_mis, mposb, device)
        rows = np.repeat(np.arange(M), mis_cnt)
        # undo the within-read delta coding: segmented cumsum
        first_of_read = (np.cumsum(mis_cnt) - mis_cnt)[rows]
        cs = np.cumsum(deltas)
        seg_start = np.zeros(n_mis, np.int64)
        nz = first_of_read > 0
        seg_start[nz] = cs[first_of_read[nz] - 1]
        cols = cs - seg_start
        ref_base = win[win_off[rows] + cols].copy()
        sub = _decode_syms_ctx(p, sections[TAG_AMISB], n_mis,
                               ref_base.astype(np.uint8), 4, 4, device)
        win[win_off[rows] + cols] = sub

    # orient: reverse-complement where rev, then place into seq_flat
    src_intra = np.where(rev[sym_read], mlens[sym_read] - 1 - intra, intra)
    val = win[win_off[sym_read] + src_intra]
    val = np.where(rev[sym_read], 3 - val, val)
    seq_flat[moffs[sym_read] + intra] = _BASE_INV[val]
