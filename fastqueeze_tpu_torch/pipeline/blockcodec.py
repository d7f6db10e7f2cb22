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
base), plus the indel CIGAR streams and the PE ``-I`` insert deltas.
Reads longer than align_max_len add the long-read chunk streams: the
mapped chunks of the _lr_grid (a pure function of the lengths and the
params) with their flags, positions (anchors absolute, the rest a
residual off the previous chunk), strands, mismatches and chunk indels;
their bases leave the residual seq stream.
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
    device_raw_tables, device_shard_tables, device_tables, frozen_host_cums,
    qual_lut, qual_vocab)
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
# long-read tier (reads > align_max_len, chunked anchor mapping):
TAG_LRF = 32      # per-chunk mapped flag (chunks of non-seq-dup long reads)
TAG_LRPOS = 33    # mapped chunks: absolute window start (posb bytes)
TAG_LRREV = 34    # mapped chunks: reverse-complement flag
TAG_LRMISC = 35   # mapped chunks: mismatch count per chunk
TAG_LRMISP = 36   # mapped chunks: mismatch positions (delta, lrpb bytes)
TAG_LRMISB = 37   # mapped chunks: substituted bases, ctx = ref base
TAG_LRPA = 38     # mapped chunks: position-anchor flag (first of read /
                  #   strand change / discontiguous); non-anchors code a
                  #   2-byte zigzag residual off the previous chunk
TAG_LRPD = 39     # non-anchor chunks: zigzag pos residual (u16)
# chunk-level indels (longread_indel budget), the read path's CIGAR
# shapes at chunk granularity (these numbers coexist with pe.py's outer
# envelope tags 40/41: block payloads nest inside the PE envelope)
TAG_LRCIGF = 40   # mapped chunks: has-indel flag
TAG_LRCIGS = 41   # indel chunks: split position s
TAG_LRCIGL = 42   # indel chunks: zigzag signed gap g
TAG_LRCG2F = 43   # indel chunks: has-second-op flag
TAG_LRCG2S = 44   # 2-op chunks: second split s2
TAG_LRCG2L = 45   # 2-op chunks: zigzag signed g2

_VAR_CHUNK = 256  # var byte streams are cut into pseudo-reads for lanes

_BASE_MAP = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE_MAP[_c] = _i
_BASE_INV = np.frombuffer(b"ACGT", np.uint8)


def _lr_grid(lengths: np.ndarray, cap: int, chunk: int,
             tail_min: int = 64):
    """The long-read tier's chunk grid: (reads, offs, clens) covering
    every read longer than ``cap`` in ``chunk``-sized pieces, the final
    remainder its own chunk when >= tail_min (p.longread_tail_min,
    serialized: it shapes the decode-side grid).  Encode and decode derive
    the same grid from the lengths and the params."""
    rows = np.flatnonzero(lengths > cap)
    reads, offs, clens = [], [], []
    for r in rows:
        L = int(lengths[r])
        n = L // chunk
        reads += [r] * n
        offs += [j * chunk for j in range(n)]
        clens += [chunk] * n
        rem = L - n * chunk
        if rem >= tail_min:
            reads.append(r)
            offs.append(n * chunk)
            clens.append(rem)
    return (np.asarray(reads, np.int64), np.asarray(offs, np.int64),
            np.asarray(clens, np.int64))


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
                 decode: bool = False, ctx_shard=None):
    """Dispatch the seq and qual streams, each (model, symbols or payload,
    per-read counts): frozen against ``frozen``'s tables, adaptive from a
    fresh table when it is None, or adaptive from its raw counts with
    frozen_adapt.  Frozen streams go to the native host coder where
    host_frozen.route says so and fresh adaptive ones where host_adapt.route
    does (bit-identical either way); frozen_adapt streams have no native
    coder (as in the reference) and always take ``device``.  ctx_shard (a
    decode's device list): the frozen qual stream decodes with its table
    split by rows over those devices (K18) when the rows divide evenly.
    Returns the two jobs."""
    jobs = [None, None]
    adapt = frozen is None or bool(p.frozen_adapt)
    tables = (None, None)
    shard = False
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
        shard = (decode and ctx_shard is not None and len(ctx_shard) >= 2
                 and jobs[1] is None
                 and qual[0].n_ctx % len(ctx_shard) == 0)
        if None in jobs:
            tables = device_tables(frozen, qual[0].alphabet,
                                   p.qctx_eff_init(), device,
                                   qual=not shard)
        if shard:
            tables = (tables[0], device_shard_tables(
                frozen, qual[0].alphabet, p.qctx_eff_init(), ctx_shard))
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
            kw = {"ctx_shard": ctx_shard} if shard and i == 1 else {}
            job = decode_stream_job if decode else encode_stream_job
            jobs[i] = job(m, p, data, counts, counts0=tables[i],
                          adapt=adapt, device=device, **kw)
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

    # --- long-read tier: mapped chunks of reads > align_max_len are
    #     rebuilt from the reference, so their bases leave the residual
    #     seq stream ---
    lr = align.chunks if align is not None and not self_ref else None
    lr_sub = np.zeros(R, np.int64)        # mapped-chunk bases per read
    lr_excl = None
    if lr is not None and len(lr[0]):
        lr_reads, lr_offs, lr_clens, lr_res = lr
        lr_keep = ~sdup[lr_reads] if n_sd else np.ones(len(lr_reads), bool)
        lr_cm = lr_res.mapped & lr_keep
        if lr_cm.any():
            np.add.at(lr_sub, lr_reads[lr_cm], lr_clens[lr_cm])
            cl = lr_clens[lr_cm]
            lr_excl = (np.repeat((np.cumsum(lengths) - lengths)[
                lr_reads[lr_cm]] + lr_offs[lr_cm], cl) + _intra_of(cl))
        else:
            lr = None
    else:
        lr = None

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
    seq_counts = (lengths - dege_cnt - lr_sub)[seq_keep]
    seq_sel = ~dege_mask
    if n_mapped:
        seq_sel &= ~np.repeat(mapped, lengths)
    if n_sd:
        seq_sel &= ~sdup_sym
    if lr_excl is not None:
        seq_sel[lr_excl] = False       # mapped chunks ride the reference
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
    if lr is not None:
        if ref_codes is None:
            raise ValueError("the long-read tier needs the reference codes")
        align_sections += _encode_lr_streams(
            p, block, lr_reads, lr_offs, lr_clens, lr_res, lr_keep, lr_cm,
            ref_codes, meta, device)

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

    rows, cols, deltas = _mis_deltas(mm)
    # indel ops: split s + signed gap g per flagged read, plus an optional
    # second op (s2, g2); mismatches stay in spliced-window coords
    ops = _gap_ops(align, mapped)

    # substituted base = effective-strand read base at the window col;
    # context = the spliced reference base it replaced (filler 0 under
    # insertions), exactly as decode builds the window
    moffs = (np.cumsum(lengths) - lengths)[mapped]
    eff_col = np.where(rev[rows], mlens[rows] - 1 - cols, cols)
    read_base = _BASE_MAP[block.seq_flat[moffs[rows] + eff_col]]
    sub_base = np.where(rev[rows], 3 - read_base, read_base).astype(np.uint8)
    ref_base = _ref_ctx(ref_codes, pos, rows, cols, ops)

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
    if ops[0] is not None:
        sections += _cigar_sections(p, ops, mposb, p.max_indel, _READ_CIGAR,
                                    meta, ("nidl", "nidl2"), device)
    return sections


# indel streams of the read path and of the long-read chunks: has-op
# flag, split, zigzag gap; second-op flag, split, gap
_READ_CIGAR = (TAG_ACIGF, TAG_ACIGS, TAG_ACIGL, TAG_ACG2F, TAG_ACG2S,
               TAG_ACG2L)
_LR_CIGAR = (TAG_LRCIGF, TAG_LRCIGS, TAG_LRCIGL, TAG_LRCG2F, TAG_LRCG2S,
             TAG_LRCG2L)


def _mis_deltas(mm: np.ndarray):
    """Mismatch (row, col) pairs of a mask, row-major (per row ascending),
    and each col's delta within its row (the first absolute)."""
    rows, cols = np.nonzero(mm)
    prev = np.empty_like(cols)
    prev[0:1] = 0
    prev[1:] = cols[:-1]
    first = np.empty(len(rows), bool)
    first[0:1] = True
    first[1:] = rows[1:] != rows[:-1]
    return rows, cols, np.where(first, cols, cols - prev)


def _gap_ops(res, sel: np.ndarray):
    """(g, s, g2, s2) of the selected rows' indel ops as int64: all None
    when no selected row has an op, g2 and s2 None when none has a second
    op."""
    g_m = s_m = g2_m = s2_m = None
    if res.gap_len is not None:
        g_all = res.gap_len[sel].astype(np.int64)
        if (g_all != 0).any():
            g_m = g_all
            s_m = res.gap_pos[sel].astype(np.int64)
            if res.gap_len2 is not None and (res.gap_len2[sel] != 0).any():
                g2_m = res.gap_len2[sel].astype(np.int64)
                s2_m = res.gap_pos2[sel].astype(np.int64)
    return g_m, s_m, g2_m, s2_m


def _ref_ctx(ref_codes: np.ndarray, pos, rows, cols, ops) -> np.ndarray:
    """The spliced-window reference base under each mismatch (filler 0
    under inserted bases); windows are clipped to the reference as decode
    clips them (self-ref windows may overhang its end by up to max_mis
    force-masked bases)."""
    g_m, s_m, g2_m, s2_m = ops
    hi = max(ref_codes.size - 1, 0)
    if g_m is None:
        return ref_codes[np.clip(pos[rows] + cols, 0, hi)]
    shift = np.where(cols >= s_m[rows], g_m[rows], 0)
    ins = ((g_m[rows] < 0) & (cols >= s_m[rows])
           & (cols < s_m[rows] - g_m[rows]))
    if g2_m is not None:
        shift = shift + np.where(cols >= s2_m[rows], g2_m[rows], 0)
        ins |= ((g2_m[rows] < 0) & (cols >= s2_m[rows])
                & (cols < s2_m[rows] - g2_m[rows]))
    return np.where(ins, 0, ref_codes[np.clip(pos[rows] + cols + shift, 0,
                                              hi)])


def _cigar_sections(p: CodecParams, ops, mposb: int, max_gap: int, tags,
                    meta: Dict, keys, device) -> list:
    """The indel streams of the rows with an op (second-op streams nested
    under them: the second pass only extends a first-pass indel, so
    g2 != 0 => g != 0)."""
    g_m, s_m, g2_m, s2_m = ops
    has = g_m != 0
    meta[keys[0]] = int(has.sum())
    gb = 1 if max_gap <= 127 else 2      # zigzag range is 2 * max_gap
    sections = [(tags[0], _code_flags(p, has, device)),
                (tags[1], _code_le(p, s_m[has], mposb, device)),
                (tags[2], _code_le(p, _zigzag(g_m[has]), gb, device))]
    if g2_m is not None and (g2_m[has] != 0).any():
        has2 = g2_m[has] != 0
        meta[keys[1]] = int(has2.sum())
        sections += [
            (tags[3], _code_flags(p, has2, device)),
            (tags[4], _code_le(p, s2_m[has][has2], mposb, device)),
            (tags[5], _code_le(p, _zigzag(g2_m[has][has2]), gb, device))]
    return sections


def _encode_lr_streams(p: CodecParams, block: FastqBlock, reads, offs,
                       clens, res, keep, cm, ref_codes: np.ndarray,
                       meta: Dict, device) -> list:
    """Long-read tier streams: the mapped chunks' flags, positions,
    strands, mismatches and indels (the read path's stream shapes at
    chunk granularity)."""
    posb = max(1, (int(ref_codes.size).bit_length() + 7) // 8)
    pos = res.pos[cm]
    rev = res.is_rev[cm]
    mm = res.mis_mask[cm]
    cl = clens[cm]
    mis_cnt = mm.sum(axis=1).astype(np.int64)
    if mis_cnt.max(initial=0) > 255:
        raise ValueError(">255 mismatches in one chunk")
    mposb = _width_of(int(cl.max()) if len(cl) else 0)
    meta["lrm"] = int(cm.sum())
    meta["lrn"] = int(keep.sum())
    meta["lrposb"] = posb
    meta["lrpb"] = mposb
    rows, cols, deltas = _mis_deltas(mm)
    ops = _gap_ops(res, cm)
    coffs = ((np.cumsum(block.lengths) - block.lengths)[reads] + offs)[cm]
    eff_col = np.where(rev[rows], cl[rows] - 1 - cols, cols)
    read_base = _BASE_MAP[block.seq_flat[coffs[rows] + eff_col]]
    sub_base = np.where(rev[rows], 3 - read_base,
                        read_base).astype(np.uint8)
    ref_base = _ref_ctx(ref_codes, pos, rows, cols, ops)
    # positions: consecutive mapped chunks of one read are nearly
    # contiguous in the reference (pos_j ~ pos_{j-1} +- (off_j -
    # off_{j-1}), sign by strand), so a non-anchor chunk codes a 2-byte
    # zigzag residual instead of a posb-byte absolute
    M = len(pos)
    r_m = reads[cm]
    off_m = offs[cm]
    sgn = np.where(rev, -1, 1).astype(np.int64)
    prev_pos = np.zeros(M, np.int64)
    prev_off = np.zeros(M, np.int64)
    prev_rev = np.zeros(M, bool)
    same = np.zeros(M, bool)
    if M > 1:
        prev_pos[1:] = pos[:-1]
        prev_off[1:] = off_m[:-1]
        prev_rev[1:] = rev[:-1]
        same[1:] = r_m[1:] == r_m[:-1]
    delta = pos - (prev_pos + sgn * (off_m - prev_off))
    anchor = ~(same & (rev == prev_rev) & (np.abs(delta) < (1 << 15)))
    meta["lrna"] = int(anchor.sum())
    sections = [
        (TAG_LRF, _code_flags(p, cm[keep], device)),
        (TAG_LRPA, _code_flags(p, anchor, device)),
        (TAG_LRPOS, _code_le(p, pos[anchor], posb, device)),
        (TAG_LRREV, _code_flags(p, rev, device)),
        (TAG_LRMISC, _code_bytes(p, mis_cnt.astype(np.uint8).tobytes(),
                                 device, order1=False)),
    ]
    if (~anchor).any():
        sections.append((TAG_LRPD, _code_le(p, _zigzag(delta[~anchor]), 2,
                                            device)))
    if len(rows):
        sections.append((TAG_LRMISP, _code_le(p, deltas, mposb, device)))
        sections.append((TAG_LRMISB, _code_syms_ctx(
            p, sub_base, ref_base.astype(np.uint8), 4, 4, device)))
    if ops[0] is not None:
        sections += _cigar_sections(p, ops, mposb, p.longread_indel,
                                    _LR_CIGAR, meta, ("lrnidl", "lrnidl2"),
                                    device)
    return sections


def decode_block(p: CodecParams, payload: bytes, frozen: Optional[Dict],
                 device, ref_codes: Optional[np.ndarray] = None,
                 ctx_shard=None) -> FastqBlock:
    """Decode one block payload on ``device`` (ref_codes: the reference's
    2-bit codes, for reference-aligned archives; ctx_shard: devices the
    frozen qual table is sharded over, driver.decompress's big-table
    mesh gate).  Any structural damage a
    corrupt payload can cause downstream (bad lengths -> out-of-range
    indexing, mangled meta JSON, impossible stream sizes) is converted to
    ValueError — the whole-block MD5 then reports it like every other
    corruption path."""
    try:
        return _decode_block_impl(p, payload, frozen, device, ref_codes,
                                  ctx_shard)
    except ValueError:
        raise
    except (IndexError, KeyError, OverflowError, TypeError,
            json.JSONDecodeError) as e:
        raise ValueError(f"corrupt block payload: {e!r}") from e


def _decode_block_impl(p: CodecParams, payload: bytes,
                       frozen: Optional[Dict], device,
                       ref_codes: Optional[np.ndarray],
                       ctx_shard=None) -> FastqBlock:
    sections = dict(iter_tlv(payload))
    meta = json.loads(sections[TAG_META].decode())
    R = meta["R"]
    n_dege = meta["nd"]
    qmax = meta["qmax"]
    n_mapped = meta.get("nm", 0)
    self_ref = bool(meta.get("sref", 0))
    if n_mapped and ref_codes is None and not self_ref:
        raise ValueError("archive was reference-aligned: decode needs the "
                         "reference FASTA")
    if meta.get("lrm", 0) and ref_codes is None:
        raise ValueError("archive has reference-mapped long-read chunks: "
                         "decode needs the reference FASTA")

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

    # --- long-read tier: chunk grid + mapped-chunk flags (needed before
    #     the seq dispatch: mapped chunks' bases are not in the stream) ---
    lr_reads = lr_offs = lr_clens = lr_cm = None
    lr_sub = np.zeros(R, np.int64)
    if TAG_LRF in sections and p.longread_chunk and R:
        C = min(p.longread_chunk, p.align_max_len)
        lr_reads, lr_offs, lr_clens = _lr_grid(lengths, p.align_max_len, C,
                                               p.longread_tail_min)
        gkeep = ~sdup[lr_reads] if n_sd else np.ones(len(lr_reads), bool)
        nk = int(gkeep.sum())
        if nk != meta.get("lrn", nk):
            raise ValueError("corrupt block payload: LR chunk grid")
        lr_cm = np.zeros(len(lr_reads), bool)
        lr_cm[gkeep] = _decode_flags(p, sections[TAG_LRF], nk, device)
        if int(lr_cm.sum()) != meta.get("lrm", -1):
            raise ValueError("corrupt block payload: LR mapped count")
        np.add.at(lr_sub, lr_reads[lr_cm], lr_clens[lr_cm])

    # --- dispatch device streams (seq + qual), then do host work ---
    seq_counts = (lengths - dege_cnt - lr_sub)[~mapped & ~sdup]
    qlens = lengths[~qdup] if n_qd else lengths
    seq_model = seq_model_from_params(p)
    qmodel = qual_model_for(p, _qual_alphabet(qmax))
    seq_job, qual_job = _stream_jobs(
        p, frozen, device, (seq_model, sections[TAG_SEQ], seq_counts),
        (qmodel, sections[TAG_QUAL], qlens), decode=True,
        ctx_shard=ctx_shard)

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
    if lr_cm is not None and lr_cm.any():
        cl = lr_clens[lr_cm]
        spans = read_off[lr_reads[lr_cm]] + lr_offs[lr_cm]
        fill[np.repeat(spans, cl) + _intra_of(cl)] = True
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
    if lr_cm is not None and lr_cm.any():
        _decode_lr_streams(p, sections, meta, lr_reads, lr_offs, lr_clens,
                           lr_cm, read_off, ref_codes, seq_flat, device)
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
    _rebuild(p, sections, (TAG_AMISC, TAG_AMISP, TAG_AMISB), _READ_CIGAR,
             p.max_indel, pos, rev, mlens, moffs, mposb, ref_codes,
             seq_flat, device)


def _decode_gap_ops(p: CodecParams, sections: Dict, tags, M: int,
                    mposb: int, max_gap: int, device):
    """Inverse of _cigar_sections: (g, s, g2, s2) per row, 0 where none."""
    g_r, s_r, g2_r, s2_r = (np.zeros(M, np.int64) for _ in range(4))
    has = _decode_flags(p, sections[tags[0]], M, device)
    nidl = int(has.sum())
    gb = 1 if max_gap <= 127 else 2
    if nidl:
        s_r[has] = _decode_le(p, sections[tags[1]], nidl, mposb, device)
        g_r[has] = _unzigzag(_decode_le(p, sections[tags[2]], nidl, gb,
                                        device))
        if tags[3] in sections:
            has2_i = _decode_flags(p, sections[tags[3]], nidl, device)
            nidl2 = int(has2_i.sum())
            has2 = np.zeros(M, bool)
            has2[np.flatnonzero(has)[has2_i]] = True
            s2_r[has2] = _decode_le(p, sections[tags[4]], nidl2, mposb,
                                    device)
            g2_r[has2] = _unzigzag(_decode_le(p, sections[tags[5]], nidl2,
                                              gb, device))
    return g_r, s_r, g2_r, s2_r


def _rebuild(p: CodecParams, sections: Dict, mis_tags, cig_tags,
             max_gap: int, pos, rev, lens, offs, mposb: int,
             ref_codes: np.ndarray, seq_flat: np.ndarray, device) -> None:
    """M mapped reads (or chunks) of ``lens`` bases at window starts
    ``pos``, written as ACGT into seq_flat at ``offs``: the reference
    window (spliced by the indel ops: ref[pos+i] for i < s, then
    ref[pos+g+i], filler 0 over inserted bases, whose values arrive
    through the mismatch patches; a second op applies the shift g+g2 past
    s2), the mismatch patches (context = the window base they replace),
    then the reverse complement where rev.  Windows are clipped to the
    reference: self-ref windows may overhang its edges by up to max_mis
    bases, every one of them patched."""
    M = len(pos)
    cnt_raw = _decode_bytes(p, sections[mis_tags[0]], device, order1=False)
    mis_cnt = np.frombuffer(cnt_raw, np.uint8).astype(np.int64)
    if len(mis_cnt) != M:
        raise ValueError("corrupt block payload: mismatch counts")
    n_mis = int(mis_cnt.sum())
    total = int(lens.sum())
    win_off = np.cumsum(lens) - lens
    sym = np.repeat(np.arange(M), lens)
    intra = np.arange(total, dtype=np.int64) - np.repeat(win_off, lens)
    widx = np.repeat(pos, lens) + intra
    if cig_tags[0] in sections:
        g_r, s_r, g2_r, s2_r = _decode_gap_ops(p, sections, cig_tags, M,
                                               mposb, max_gap, device)
        g, s, g2, s2 = g_r[sym], s_r[sym], g2_r[sym], s2_r[sym]
        widx = widx + np.where(intra >= s, g, 0) + np.where(intra >= s2,
                                                            g2, 0)
        win = ref_codes[np.clip(widx, 0, max(ref_codes.size - 1, 0))]
        win[((g < 0) & (intra >= s) & (intra < s - g))
            | ((g2 < 0) & (intra >= s2) & (intra < s2 - g2))] = 0
    else:
        win = ref_codes[np.clip(widx, 0, max(ref_codes.size - 1, 0))]
    if n_mis:
        deltas = _decode_le(p, sections[mis_tags[1]], n_mis, mposb, device)
        rows = np.repeat(np.arange(M), mis_cnt)
        # undo the within-row delta coding: segmented cumsum
        first_of = (np.cumsum(mis_cnt) - mis_cnt)[rows]
        cs = np.cumsum(deltas)
        seg_start = np.zeros(n_mis, np.int64)
        nz = first_of > 0
        seg_start[nz] = cs[first_of[nz] - 1]
        cols = cs - seg_start
        if (cols >= lens[rows]).any():
            raise ValueError("corrupt block payload: mismatch columns")
        at = win_off[rows] + cols
        win[at] = _decode_syms_ctx(p, sections[mis_tags[2]], n_mis,
                                   win[at].astype(np.uint8), 4, 4, device)
    src = np.where(rev[sym], lens[sym] - 1 - intra, intra)
    val = win[win_off[sym] + src]
    val = np.where(rev[sym], 3 - val, val)
    seq_flat[offs[sym] + intra] = _BASE_INV[val]


def _decode_lr_streams(p: CodecParams, sections: Dict, meta: Dict, reads,
                       offs, clens, cm, read_off, ref_codes: np.ndarray,
                       seq_flat: np.ndarray, device) -> None:
    """Rebuild the mapped long-read chunks from the reference into
    seq_flat: positions first (anchors absolute, the rest the residual
    cumsum within each anchored segment), then _rebuild."""
    M = int(cm.sum())
    cl = clens[cm]
    rev = _decode_flags(p, sections[TAG_LRREV], M, device)
    anchor = _decode_flags(p, sections[TAG_LRPA], M, device)
    n_anchor = int(anchor.sum())
    if n_anchor != meta.get("lrna", n_anchor) or (M and not anchor[0]):
        raise ValueError("corrupt block payload: LR pos anchors")
    pa = _decode_le(p, sections[TAG_LRPOS], n_anchor, meta["lrposb"],
                    device)
    delta = np.zeros(M, np.int64)
    if n_anchor < M:
        delta[~anchor] = _unzigzag(_decode_le(p, sections[TAG_LRPD],
                                              M - n_anchor, 2, device))
    off_m = offs[cm]
    step = np.zeros(M, np.int64)
    if M > 1:
        step[1:] = np.where(rev[1:], -1, 1) * (off_m[1:] - off_m[:-1])
    cs = np.cumsum(np.where(anchor, 0, step + delta))
    seg = np.cumsum(anchor) - 1                  # segment of each chunk
    pos = pa[seg] + cs - cs[np.flatnonzero(anchor)[seg]]
    _rebuild(p, sections, (TAG_LRMISC, TAG_LRMISP, TAG_LRMISB), _LR_CIGAR,
             p.longread_indel, pos, rev, cl, (read_off[reads] + offs)[cm],
             meta["lrpb"], ref_codes, seq_flat, device)
