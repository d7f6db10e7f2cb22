"""Per-block stream split + entropy coding (single-end, no reference).

Copied from fastqueeze_tpu/pipeline/blockcodec.py (SE encode_block_job /
decode_block): a block of parsed records is split into independently
coded streams — lengths, read IDs (binned), plus lines, duplicate-read
back-references, degenerate (non-ACGT) bases, 2-bit sequence, quality —
each wrapped in a TLV section.  The two big streams (seq, qual) go to the
frozen wave-rANS coder on the engine's device; every other stream of at
most ``host_stream_max`` symbols goes to the native host range coder.

Not ported yet: the adaptive device coder (streams over host_stream_max,
inputs below the usemodel gate, frozen_adapt; ROADMAP Queue A item 5) and
the alignment / long-read / self-ref block streams (Queue A items 4, 8).
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
    qual_model_for, seq_model_from_params)
from fastqueeze_tpu_torch.ops import host_frozen, host_rans
from fastqueeze_tpu_torch.ops.engine import (
    decode_stream_job, encode_stream_job)
from fastqueeze_tpu_torch.pipeline.frozen import (
    device_tables, frozen_host_cums, qual_lut, qual_vocab)
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
# first tags of the alignment (14-24, 29-31) and long-read (32-45) stream
# families, whose blocks the port does not decode yet
TAG_AMAP = 14
TAG_LRF = 32

_ADAPT_MSG = "adaptive device coder: ROADMAP Queue A item 5"
_ALIGN_MSG = ("alignment / self-ref / long-read block streams: ROADMAP "
              "Queue A item 4")

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


def _code_bytes(p: CodecParams, raw: bytes, order1: bool = True) -> bytes:
    """Entropy-code a host byte string.  Marker dispatch: 0 = stored raw,
    1 = device wave-rANS (adaptive, not ported), 2 = host range coder."""
    if not raw:
        return b"\x00"
    flat = np.frombuffer(raw, np.uint8)
    if len(flat) > p.host_stream_max:
        raise NotImplementedError(_ADAPT_MSG)
    if order1:
        blob = host_rans.encode_o1(flat, 256, p.byte_init, p.byte_inc,
                                   p.byte_cap)
    else:
        blob = host_rans.encode_ctx(flat, None, 1, 256, p.byte_init,
                                    p.byte_inc, p.byte_cap)
    payload = b"\x02" + len(raw).to_bytes(4, "little") + blob
    if len(payload) >= len(raw) + 1:
        return b"\x00" + raw
    return payload


def _host_coded(blob: bytes) -> None:
    """Stream marker check: 2 = host range coder (ported), 1 = adaptive
    device coder (not ported), anything else is corruption."""
    if blob[:1] == b"\x01":
        raise NotImplementedError(_ADAPT_MSG)
    if blob[:1] != b"\x02":
        raise ValueError("corrupt block payload: unknown stream marker")


def _decode_bytes(p: CodecParams, blob: bytes, order1: bool = True) -> bytes:
    if blob[:1] == b"\x00":
        return blob[1:]
    _host_coded(blob)
    n = int.from_bytes(blob[1:5], "little")
    if order1:
        flat = host_rans.decode_o1(blob[5:], n, 256, p.byte_init,
                                   p.byte_inc, p.byte_cap)
    else:
        flat = host_rans.decode_ctx(blob[5:], n, None, 1, 256,
                                    p.byte_init, p.byte_inc, p.byte_cap)
    return flat.tobytes()


def _code_lines(p: CodecParams, lines, R: int) -> bytes:
    """Fallback line coder for IDs/plus lines when binning fails
    (reference: encode_name @0x421070, SURVEY.md §2.1 path 2).  Codes the
    lines through the tokenized previous-name diff coder (marker 3) and
    through the generic byte path; the smaller payload wins, so
    unstructured IDs (SRA hashes, instrument coords) land near entropy
    while degenerate inputs keep the raw/order-1 floor."""
    from fastqueeze_tpu_torch.io.fastq import LazyLines
    if R == 0:
        return _code_bytes(p, b"")
    if isinstance(lines, LazyLines):
        cat = np.frombuffer(lines.cat, np.uint8)
        lens = np.diff(lines.offs).astype(np.int32)
    else:
        cat = np.frombuffer(b"".join(lines), np.uint8)
        lens = np.array([len(x) for x in lines], np.int32)
    blob = host_rans.encode_names(cat, lens, p.byte_init, p.byte_inc,
                                  p.byte_cap)
    cand = b"\x03" + len(cat).to_bytes(4, "little") + blob
    alt = _code_bytes(p, b"\n".join(lines) + b"\n")
    return cand if len(cand) < len(alt) else alt


def _decode_lines(p: CodecParams, blob: bytes, R: int) -> List[bytes]:
    if blob[:1] == b"\x03":
        total = int.from_bytes(blob[1:5], "little")
        cat, lens = host_rans.decode_names(blob[5:], R, total, p.byte_init,
                                           p.byte_inc, p.byte_cap)
        offs = np.concatenate(([0], np.cumsum(lens, dtype=np.int64)))
        c = cat.tobytes()
        return [c[offs[i]:offs[i + 1]] for i in range(R)]
    raw = _decode_bytes(p, blob)
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


def _code_flags(p: CodecParams, bits: np.ndarray) -> bytes:
    """Entropy-code a boolean vector through the host order-1 binary
    model (marker 2; marker 1 = adaptive device coder, not ported)."""
    if len(bits) > p.host_stream_max:
        raise NotImplementedError(_ADAPT_MSG)
    return b"\x02" + host_rans.encode_o1(bits.astype(np.uint8), 2,
                                         p.byte_init, p.byte_inc,
                                         p.byte_cap)


def _decode_flags(p: CodecParams, blob: bytes, n: int) -> np.ndarray:
    _host_coded(blob)
    return host_rans.decode_o1(blob[1:], n, 2, p.byte_init, p.byte_inc,
                               p.byte_cap).astype(bool)


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


def _code_le(p: CodecParams, values: np.ndarray, nbytes: int) -> bytes:
    syms, ctx = _le_byte_stream(values.astype(np.int64), nbytes)
    if len(syms) > p.host_stream_max:
        raise NotImplementedError(_ADAPT_MSG)
    return b"\x02" + host_rans.encode_ctx(
        syms, ctx.astype(np.uint32), nbytes, 256, p.byte_init,
        p.byte_inc, p.byte_cap)


def _decode_le(p: CodecParams, blob: bytes, n: int, nbytes: int) -> np.ndarray:
    _host_coded(blob)
    ctx = np.tile(np.arange(nbytes, dtype=np.uint8), n)
    syms = host_rans.decode_ctx(blob[1:], n * nbytes,
                                ctx.astype(np.uint32), nbytes, 256,
                                p.byte_init, p.byte_inc, p.byte_cap)
    return _from_le_bytes(syms, n, nbytes)


def encode_block(p: CodecParams, block: FastqBlock, frozen: Dict,
                 device, dbg=None) -> bytes:
    return encode_block_job(p, block, frozen, device, dbg)()


def encode_block_job(p: CodecParams, block: FastqBlock, frozen: Dict,
                     device, dbg=None):
    """Dispatch phase of encode_block: the seq and qual streams are queued
    on the device and the host streams coded; the returned thunk syncs
    the device and assembles the block TLV, so a driver keeps the next
    block's host work running while the device codes this one."""
    if frozen is None or p.frozen_adapt:
        raise NotImplementedError(_ADAPT_MSG)
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

    # --- quality vocabulary: rank space fixed by the trained tables;
    #     values unseen in training get fresh ranks appended
    #     (fit_qual_alphabet pads the frozen table with init rows) ---
    block_qvals, _ = qual_vocab(block.qual_flat)   # validates char range
    base = np.asarray(frozen["qvals"], np.uint8)
    extra = np.setdiff1d(block_qvals, base)
    qvals = np.concatenate([base, extra]) if len(extra) else base
    qsyms = qual_lut(qvals)[block.qual_flat]
    qmax = max(len(qvals) - 1, 0)

    const_len = int(lengths[0]) if R and (lengths == lengths[0]).all() else None
    meta = {
        "R": R,
        "clen": const_len,
        "fnl": block.final_newline,
        "qmax": qmax,
        "qv": qvals.tolist(),
        "nd": n_dege,
        "nm": 0,
    }

    # --- dispatch the big device streams first (seq + qual); host streams
    #     are coded while the device crunches, then the jobs are finalized
    seq_keep = ~sdup if n_sd else np.ones(R, bool)
    seq_counts = (lengths - dege_cnt)[seq_keep]
    seq_sel = ~dege_mask
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
    seq_job = qual_job = None
    route_s = host_frozen.route(p, seq_model, device)
    route_q = host_frozen.route(p, qmodel, device)
    if route_s or route_q:
        # native host coder (bit-identical bitstream; the oracle)
        sc_cum, qc_cum = frozen_host_cums(frozen, qmodel.alphabet,
                                          p.qctx_eff_init())
        if route_s:
            seq_job = host_frozen.encode_job(seq_model, p, seq_syms,
                                             seq_counts, sc_cum)
        if route_q:
            qual_job = host_frozen.encode_job(qmodel, p, qsyms, qlens,
                                              qc_cum)
    if seq_job is None or qual_job is None:
        sc0, qc0 = device_tables(frozen, qmodel.alphabet, p.qctx_eff_init(),
                                 device)
        if seq_job is None:
            seq_job = encode_stream_job(seq_model, p, seq_syms, seq_counts,
                                        counts0=sc0, device=device)
        if qual_job is None:
            qual_job = encode_stream_job(qmodel, p, qsyms, qlens,
                                         counts0=qc0, device=device)

    # --- lengths (reference: encode_len_short/encode_len_long, SURVEY.md
    #     §2.1 — variable-width tiers; long reads (ONT/PacBio) take the
    #     4-byte tier instead of hard-failing) ---
    len_payload = None
    if const_len is None and R:
        lenb = _width_of(int(lengths.max()))
        if lenb != 2:
            meta["lenb"] = lenb
        len_payload = _code_le(p, lengths, lenb)

    # --- IDs (host binning) ---
    schema, var_payload = analyze_ids(block.ids)
    id_sections = []
    if schema is not None:
        id_sections.append((TAG_IDSCHEMA, schema.to_json()))
        if var_payload:
            id_sections.append((TAG_IDVAR, _code_bytes(p, var_payload)))
    else:
        id_sections.append((TAG_IDRAW, _code_lines(p, block.ids, R)))

    # --- plus lines ---
    from fastqueeze_tpu_torch.io.fastq import any_content
    plus_sections = []
    if any_content(block.plus):
        pschema, pvar = analyze_ids(block.plus)
        if pschema is not None:
            plus_sections.append((TAG_PLUSSCHEMA, pschema.to_json()))
            if pvar:
                plus_sections.append((TAG_PLUSVAR, _code_bytes(p, pvar)))
        else:
            plus_sections.append((TAG_PLUSRAW,
                                  _code_lines(p, block.plus, R)))

    # --- duplicate-tier streams ---
    def _dup_dist(d):
        """Distance payload: absolute or consecutive-delta (zigzag),
        whichever codes smaller — replicated inputs give near-constant
        distances whose deltas are ~all zero."""
        w_abs = _width_of(int(d.max()))
        pay_abs = _code_le(p, d, w_abs)
        dd = np.diff(d, prepend=0)
        zz = np.where(dd >= 0, 2 * dd, -2 * dd - 1)
        w_dl = _width_of(int(zz.max()))
        pay_dl = _code_le(p, zz, w_dl)
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
        dup_sections += [(TAG_SDUPF, _code_flags(p, sdup)),
                         (TAG_SDUPD, pay)]
    if n_qd:
        pay, w, dl = _dup_dist((np.arange(R, dtype=np.int64) - q_src)[qdup])
        meta["nqd"] = n_qd
        meta["qdb"] = w
        if dl:
            meta["qdd"] = 1
        dup_sections += [(TAG_QDUPF, _code_flags(p, qdup)),
                         (TAG_QDUPD, pay)]

    # --- degenerate streams ---
    dege_sections = []
    if n_dege:
        if int(dege_cnt.max()) > 0xFF:
            meta["degcb"] = _width_of(int(dege_cnt.max()))
            cnt_payload = _code_le(p, dege_cnt, meta["degcb"])
        else:
            cnt_payload = _code_bytes(
                p, dege_cnt.astype(np.uint8).tobytes(), order1=False)
        degpb = _width_of(int(dege_pos.max()) if len(dege_pos) else 0)
        degpb = max(degpb, 2)       # 2 is the historical default width
        if degpb != 2:
            meta["degpb"] = degpb
        pos_payload = _code_le(p, dege_pos, degpb)
        chr_payload = _code_bytes(
            p, block.seq_flat[dege_mask].tobytes(), order1=False)
        dege_sections = [(TAG_DEGCNT, cnt_payload), (TAG_DEGPOS, pos_payload),
                         (TAG_DEGCHR, chr_payload)]
    def finalize() -> bytes:
        # --- collect the device streams, assemble TLV ---
        seq_payload = seq_job.finalize()
        qual_payload = qual_job.finalize()
        out.write(write_tlv(TAG_META, json.dumps(meta).encode()))
        if len_payload is not None:
            out.write(write_tlv(TAG_LEN, len_payload))
        for tag, payload in (dup_sections + dege_sections + id_sections
                             + plus_sections):
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
            dbg.add("sz_dup", sum(len(x) for _, x in dup_sections))
            dbg.add("dup_seq_reads", n_sd)
            dbg.add("dup_qual_reads", n_qd)
            dbg.add("raw_seq", nsym)
            dbg.add("raw_qual", nsym)
        return out.getvalue()

    return finalize


def decode_block(p: CodecParams, payload: bytes, frozen: Optional[Dict],
                 device) -> FastqBlock:
    """Decode one block payload on ``device``.  Any structural damage a
    corrupt payload can cause downstream (bad lengths -> out-of-range
    indexing, mangled meta JSON, impossible stream sizes) is converted to
    ValueError — the whole-block MD5 then reports it like every other
    corruption path."""
    try:
        return _decode_block_impl(p, payload, frozen, device)
    except ValueError:
        raise
    except (IndexError, KeyError, OverflowError, TypeError,
            json.JSONDecodeError) as e:
        raise ValueError(f"corrupt block payload: {e!r}") from e


def _decode_block_impl(p: CodecParams, payload: bytes,
                       frozen: Optional[Dict], device) -> FastqBlock:
    sections = dict(iter_tlv(payload))
    meta = json.loads(sections[TAG_META].decode())
    R = meta["R"]
    n_dege = meta["nd"]
    qmax = meta["qmax"]
    if (meta.get("nm", 0) or meta.get("sref", 0) or meta.get("lrm", 0)
            or TAG_AMAP in sections or TAG_LRF in sections):
        raise NotImplementedError(_ALIGN_MSG)
    if frozen is None or p.frozen_adapt:
        raise NotImplementedError(_ADAPT_MSG)

    # --- lengths ---
    if meta["clen"] is not None:
        lengths = np.full(R, meta["clen"], np.int64)
    elif R:
        lengths = _decode_le(p, sections[TAG_LEN], R, meta.get("lenb", 2))
    else:
        lengths = np.zeros(0, np.int64)
    if R and (lengths.min() < 0 or int(lengths.sum()) > (1 << 33)):
        raise ValueError("corrupt block payload: implausible read lengths")

    # --- degenerate streams ---
    dege_cnt = np.zeros(R, np.int64)
    if n_dege:
        if "degcb" in meta:
            dege_cnt = _decode_le(p, sections[TAG_DEGCNT], R, meta["degcb"])
        else:
            cnt_raw = _decode_bytes(p, sections[TAG_DEGCNT], order1=False)
            dege_cnt = np.frombuffer(cnt_raw, np.uint8).astype(np.int64)
        dpos = _decode_le(p, sections[TAG_DEGPOS], n_dege,
                          meta.get("degpb", 2))
        dchr = np.frombuffer(
            _decode_bytes(p, sections[TAG_DEGCHR], order1=False), np.uint8)

    # --- duplicate-tier back-references ---
    def _dup_refs(tag_f, tag_d, n_dup, width, delta):
        flags = _decode_flags(p, sections[tag_f], R)
        rows = np.flatnonzero(flags)
        if len(rows) != n_dup:
            raise ValueError("corrupt block payload: dup flag count")
        d = _decode_le(p, sections[tag_d], n_dup, width)
        if delta:
            dd = np.where(d % 2 == 0, d // 2, -((d + 1) // 2))
            d = np.cumsum(dd)
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
    seq_counts = (lengths - dege_cnt)[~sdup]
    qlens = lengths[~qdup] if n_qd else lengths
    seq_model = seq_model_from_params(p)
    qmodel = qual_model_for(p, _qual_alphabet(qmax))
    seq_job = qual_job = None
    route_s = host_frozen.route(p, seq_model, device)
    route_q = host_frozen.route(p, qmodel, device)
    if route_s or route_q:
        sc_cum, qc_cum = frozen_host_cums(frozen, qmodel.alphabet,
                                          p.qctx_eff_init())
        if route_s:
            seq_job = host_frozen.decode_job(
                seq_model, p, sections[TAG_SEQ], seq_counts, sc_cum)
        if route_q:
            qual_job = host_frozen.decode_job(
                qmodel, p, sections[TAG_QUAL], qlens, qc_cum)
    if seq_job is None or qual_job is None:
        sc0, qc0 = device_tables(frozen, qmodel.alphabet, p.qctx_eff_init(),
                                 device)
        if seq_job is None:
            seq_job = decode_stream_job(seq_model, p, sections[TAG_SEQ],
                                        seq_counts, counts0=sc0,
                                        device=device)
        if qual_job is None:
            qual_job = decode_stream_job(qmodel, p, sections[TAG_QUAL],
                                         qlens, counts0=qc0, device=device)

    # --- sequence assembly (host) ---
    seq_flat = np.empty(int(lengths.sum()), np.uint8)
    read_off = np.cumsum(lengths) - lengths
    fill = np.zeros(len(seq_flat), bool)   # True where a byte is written
    if n_dege:
        dege_abs = np.repeat(read_off, dege_cnt) + dpos
        seq_flat[dege_abs] = dchr
        fill[dege_abs] = True
    if n_sd:
        fill |= np.repeat(sdup, lengths)
    acgt = seq_job.finalize()
    seq_flat[~fill] = _BASE_INV[acgt]
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
        var = (_decode_bytes(p, sections[TAG_IDVAR])
               if TAG_IDVAR in sections else b"")
        ids = reconstruct_ids(schema, R, var)
    else:
        ids = _decode_lines(p, sections[TAG_IDRAW], R)

    # --- plus lines ---
    if TAG_PLUSSCHEMA in sections:
        pschema = IdBinSchema.from_json(sections[TAG_PLUSSCHEMA])
        pvar = (_decode_bytes(p, sections[TAG_PLUSVAR])
                if TAG_PLUSVAR in sections else b"")
        plus = reconstruct_ids(pschema, R, pvar)
    elif TAG_PLUSRAW in sections:
        plus = _decode_lines(p, sections[TAG_PLUSRAW], R)
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

