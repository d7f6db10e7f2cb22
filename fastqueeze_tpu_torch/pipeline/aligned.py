"""Reference-aligned compression, single-end and paired-end.

Copied from fastqueeze_tpu/pipeline/aligned.py: per block, align the
reads (align/hash.py; K8 and K9 on the card, or K8 and K14 with
FASTQUEEZE_FUSED_ALIGN=1), and the chunks of the reads longer than
align_max_len (the long-read tier), then encode with the alignment
streams, or entropy-only when the block's mapped fraction is under
``min_map_ratio`` (the reference's per-block Align/Fqz decision).  PE
blocks align their mates interleaved and, with -I (max_insr), rescue an
unmapped mate inside its mapped mate's insert window (K10).  -l
transforms each block's qualities before its MD5; ``part=(k, n)``
(--part K:N) writes the partial archive of blocks k, k+n, ... (see
driver.compress_se); --mesh N round-robins whole blocks over N devices,
each aligning against its own copy of the index (Aligner.dev_index).  An
index past SHARD_MIN_POSITIONS goes to the index-sharded aligner
(align/sharded.py, K19).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fastqueeze_tpu_torch.align.hash import Aligner, AlignResult
from fastqueeze_tpu_torch.align.index import load_index
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import (
    FLAG_ALIGNED, FLAG_PE, ArcWriter, BlockInfo)
from fastqueeze_tpu_torch.io.fastq import FastqBlock, parse_block, read_blocks
from fastqueeze_tpu_torch.pipeline.blockcodec import (
    _BASE_MAP, _intra_of, _lr_grid, dup_masks, encode_block)
from fastqueeze_tpu_torch.pipeline.driver import (
    owned_blocks, train_frozen_prefix)
from fastqueeze_tpu_torch.pipeline.lossy import lossy_pair, parse_lossy
from fastqueeze_tpu_torch.pipeline.parallel_host import (
    block_dp_devices, device_parallel)
from fastqueeze_tpu_torch.utils.metrics import DebugInfo


def _read_codes(block: FastqBlock) -> Tuple[np.ndarray, np.ndarray]:
    codes = _BASE_MAP[block.seq_flat]
    dege = codes == 255
    return np.where(dege, 0, codes).astype(np.uint8), dege


def align_block(aligner: Aligner, block: FastqBlock, device,
                dup_src: Optional[np.ndarray] = None) -> AlignResult:
    """Align a block's reads, and the chunks of its reads longer than
    align_max_len (_chunk_align).  With dup_src (the duplicate tier's
    first-occurrence back-references), only unique reads run the aligner
    and each duplicate inherits its source's result: the aligner is
    deterministic per read, so the archive is the same."""
    codes, dege = _read_codes(block)
    if dup_src is None:
        res = aligner.align(codes, dege, block.lengths, device)
        return res._replace(chunks=_chunk_align(aligner, block, codes, dege,
                                                device))
    keep = dup_src < 0
    sym_keep = np.repeat(keep, block.lengths)
    sub = aligner.align(codes[sym_keep], dege[sym_keep],
                        block.lengths[keep], device)
    R = block.n_reads
    rows = np.flatnonzero(keep)
    src = dup_src[~keep]             # first occurrences: always in `rows`

    def spread(a):
        if a is None:
            return None
        out = np.zeros((R,) + a.shape[1:], a.dtype)
        out[rows] = a
        out[~keep] = out[src]
        return out

    return AlignResult(*(spread(a) for a in sub[:8]),
                       _chunk_align(aligner, block, codes, dege, device,
                                    keep_read=keep))


def _chunk_align(aligner: Aligner, block: FastqBlock, codes: np.ndarray,
                 dege: np.ndarray, device, keep_read=None):
    """The long-read tier: reads longer than align_max_len are mapped in
    longread_chunk pieces through the ordinary tiers, with the gap budget
    longread_indel.  The grid is blockcodec._lr_grid, derived from the
    lengths and the params on both sides (no structure bytes).  Duplicate
    long reads restore by copy, so their chunks are not aligned.  Returns
    (reads, offs, clens, AlignResult of the chunks), or None."""
    p = aligner.params
    cap = p.align_max_len
    C = min(p.longread_chunk, cap)
    if not C or not len(block.lengths) or int(block.lengths.max()) <= cap:
        return None
    reads, offs, clens = _lr_grid(block.lengths, cap, C, p.longread_tail_min)
    if not len(reads):
        return None
    sel = (np.ones(len(reads), bool) if keep_read is None
           else keep_read[reads])
    starts = np.cumsum(block.lengths) - block.lengths

    def run(ks):
        idx = (np.repeat(starts[reads[ks]] + offs[ks], clens[ks])
               + _intra_of(clens[ks]))
        return aligner.align(codes[idx], dege[idx], clens[ks], device,
                             allow_indel=p.longread_indel > 0,
                             max_indel=p.longread_indel)

    if sel.all():
        return reads, offs, clens, run(np.arange(len(reads)))
    ks = np.flatnonzero(sel)
    n = len(reads)
    s = run(ks) if len(ks) else None
    lp = s.mis_mask.shape[1] if s is not None else 0
    mm = np.zeros((n, max(lp, 16)), bool)
    out = [np.zeros(n, bool), np.zeros(n, np.int64), np.zeros(n, bool), mm]
    gaps = [None] * 4
    if s is not None:
        for dst, src in zip(out[:3], s[:3]):
            dst[ks] = src
        mm[ks, :lp] = s.mis_mask
        if s.gap_pos is not None:
            gaps = [np.zeros(n, np.int32) for _ in range(4)]
            for dst, src in zip(gaps, s[4:8]):
                dst[ks] = src
    return reads, offs, clens, AlignResult(*out, *gaps)


def _maybe_align(p: CodecParams, aligner: Aligner, block: FastqBlock,
                 device, dbg: DebugInfo):
    """Align the block; (None, 0) when its mapped fraction is under
    min_map_ratio (coded entropy-only), else (AlignResult, n_mapped).  A
    block with mapped long-read chunks gates on the mapped share of its
    bases instead, when that is larger."""
    with dbg.span("align"):
        dup_src = None
        if p.dedup and block.n_reads > 1:
            dup_src, _ = dup_masks(block)
        res = align_block(aligner, block, device, dup_src)
    n_mapped = int(res.mapped.sum())
    frac = n_mapped / block.n_reads if block.n_reads else 0.0
    if res.chunks is not None and res.chunks[3].mapped.any():
        ch = res.chunks
        mapped_b = (int(block.lengths[res.mapped].sum())
                    + int(ch[2][ch[3].mapped].sum()))
        frac = max(frac, mapped_b / max(int(block.lengths.sum()), 1))
        dbg.add("lr_chunks_mapped", int(ch[3].mapped.sum()))
    if block.n_reads and frac < p.min_map_ratio:
        dbg.add("fqz_blocks", 1)
        return None, 0
    dbg.add("align_blocks", 1)
    dbg.add("mapped_reads", n_mapped)
    return res, n_mapped


# (path, mtime, size, seed_len, shm) -> (Aligner, RefSeq): repeated
# compress/decompress calls in one process skip the FASTA parse, the index
# load and the upload to the card.  Aligner.params is re-stamped per call.
_REF_CACHE: Dict = {}
_REF_CACHE_MAX = 4


def prepare_ref(p: CodecParams, ref_path: str, device="cuda"):
    """Load (or build) the index and stamp the reference's identity
    (aligned, ref_md5, ref_len, seed_len) into the params.  An index at
    or past sharded.SHARD_MIN_POSITIONS positions (or reference bases)
    goes to the ShardedAligner over the visible devices of ``device``'s
    kind."""
    try:
        st = os.stat(ref_path)
        key = (os.path.abspath(ref_path), st.st_mtime_ns, st.st_size,
               p.seed_len, p.shm_index)
    except OSError:
        key = None
    hit = _REF_CACHE.get(key) if key is not None else None
    if hit is None:
        idx, ref = load_index(ref_path, p)
        from fastqueeze_tpu_torch.align import sharded
        if (idx.n_positions >= sharded.SHARD_MIN_POSITIONS
                or idx.ref_len >= sharded.SHARD_MIN_POSITIONS):
            aligner = sharded.ShardedAligner(
                idx, p, kind=torch.device(device).type)
        else:
            aligner = Aligner(idx, p)
        if key is not None:
            if len(_REF_CACHE) >= _REF_CACHE_MAX:
                _REF_CACHE.pop(next(iter(_REF_CACHE)))
            _REF_CACHE[key] = (aligner, ref)
    else:
        aligner, ref = hit
        aligner.params = p
    p.aligned = 1
    p.ref_md5 = ref.md5
    p.ref_len = ref.length
    p.seed_len = aligner.k
    return aligner, ref


def compress_se_aligned(p: CodecParams, ref_path: str, in_path: str,
                        out_path: str, dbg: Optional[DebugInfo] = None,
                        part: Optional[tuple] = None, device="cuda") -> Dict:
    devices = block_dp_devices(p, device)
    from fastqueeze_tpu_torch.pipeline.frozen import decide_use_model
    dbg = dbg or DebugInfo()
    with dbg.span("ref"):
        aligner, ref = prepare_ref(p, ref_path, device)
    block_size = p.block_bytes or p.block_size_mb * (1 << 20)
    whole_md5 = hashlib.md5()
    writer = ArcWriter(out_path, p, [os.path.basename(in_path)], [],
                       part=part)
    frozen = None
    if decide_use_model(p, os.path.getsize(in_path)):
        frozen, blob = train_frozen_prefix(p, in_path, device, dbg)
        writer.set_model(blob)
    single = not part or part[1] == 1

    def scan(item):
        raw, final_nl, block = item
        if p.lossy_factor > 1.0:
            raw, block = parse_lossy(p, raw, final_nl)
        whole_md5.update(raw)
        return raw, final_nl, block

    def work(_i, gi_item, device):
        gi, (raw, final_nl, block) = gi_item
        if block is None:
            raw, block = parse_lossy(p, raw, final_nl)
        align, n_mapped = _maybe_align(p, aligner, block, device, dbg)
        with dbg.span("encode"):
            payload = encode_block(p, block, frozen, device, dbg, align,
                                   ref.codes)
        return gi, raw, payload, block.n_reads, n_mapped, align is not None

    n_blocks = total_raw = total_mapped = total_reads = 0
    items = ((raw, final_nl, None)
             for raw, final_nl in read_blocks(in_path, block_size))
    for _, (gi, raw, payload, n_reads, n_mapped, was_aligned) in \
            device_parallel(owned_blocks(items, part, scan), work, devices,
                            p.threads, device):
        if single:                 # ordered: blocks arrive in file order
            whole_md5.update(raw)
        writer.add_block(gi, payload, BlockInfo(
            payload_len=len(payload), n_reads=n_reads, raw_len1=len(raw),
            flags=FLAG_ALIGNED if was_aligned else 0,
            md5=hashlib.md5(raw).digest()))
        total_mapped += n_mapped
        total_reads += n_reads
        total_raw += len(raw)
        n_blocks += 1
    writer.input_md5s = [whole_md5.digest()]
    writer.finalize()
    out_size = os.path.getsize(out_path)
    dbg.add("raw_bytes", total_raw)
    dbg.add("out_bytes", out_size)
    return {"blocks": n_blocks, "raw": total_raw, "compressed": out_size,
            "ratio": total_raw / out_size if out_size else 0.0,
            "mapped": total_mapped, "reads": total_reads}


def compress_pe_aligned(p: CodecParams, ref_path: str, in1: str, in2: str,
                        out_path: str, dbg: Optional[DebugInfo] = None,
                        part: Optional[tuple] = None, device="cuda") -> Dict:
    """PE against a reference: mates interleaved into one block and every
    read aligned; with max_insr > 0 an unmapped mate of a mapped one is
    re-verified inside the insert window (Aligner.rescue_mates); the pair
    relations and the modal insert go to ``dbg``."""
    from fastqueeze_tpu_torch.pipeline.frozen import (
        decide_use_model, serialize_frozen)
    from fastqueeze_tpu_torch.pipeline.pe import (
        _RecordReader, interleave_blocks, pe_block_items, pe_payload,
        train_frozen_pe_prefix)
    devices = block_dp_devices(p, device)
    dbg = dbg or DebugInfo()
    with dbg.span("ref"):
        aligner, ref = prepare_ref(p, ref_path, device)
    p.is_pe = 1
    md5_1, md5_2 = hashlib.md5(), hashlib.md5()
    writer = ArcWriter(out_path, p,
                       [os.path.basename(in1), os.path.basename(in2)], [],
                       part=part)
    frozen = None
    if decide_use_model(p, os.path.getsize(in1) + os.path.getsize(in2)):
        frozen = train_frozen_pe_prefix(p, in1, in2, device, dbg)
        writer.set_model(serialize_frozen(frozen))
    rr2 = _RecordReader(in2)
    single = not part or part[1] == 1

    def scan(item):
        raw1, fnl1, raw2, fnl2, b1, b2 = item
        if p.lossy_factor > 1.0:
            raw1, b1, raw2, b2 = lossy_pair(p, raw1, parse_block(raw1, fnl1),
                                            raw2, parse_block(raw2, fnl2))
        md5_1.update(raw1)
        md5_2.update(raw2)
        return raw1, fnl1, raw2, fnl2, b1, b2

    def work(_i, gi_item, device):
        gi, (raw1, fnl1, raw2, fnl2, b1, b2) = gi_item
        if b1 is None:
            raw1, b1, raw2, b2 = lossy_pair(p, raw1, parse_block(raw1, fnl1),
                                            raw2, parse_block(raw2, fnl2))
        merged = interleave_blocks(b1, b2)
        align, n_mapped = _maybe_align(p, aligner, merged, device, dbg)
        if align is not None and p.max_insr > 0:
            with dbg.span("align"):
                codes, dege = _read_codes(merged)
                before = n_mapped
                align = aligner.rescue_mates(codes, dege, merged.lengths,
                                             align, p.max_insr, device)
                n_mapped = int(align.mapped.sum())
                dbg.add("pe_rescued", n_mapped - before)
        if align is not None:
            _tally_pe_relations(align, dbg)
        with dbg.span("encode"):
            body = encode_block(p, merged, frozen, device, dbg, align,
                                ref.codes)
        return (gi, raw1, raw2, pe_payload(b1.final_newline,
                                           b2.final_newline, body),
                b1.n_reads,
                merged.n_reads, n_mapped, align is not None)

    n_blocks = total_raw = total_mapped = total_reads = 0
    items = (item + (None, None) for item in pe_block_items(p, in1, rr2))
    for _, (gi, raw1, raw2, payload, n_pairs, n_merged, n_mapped,
            was_aligned) in device_parallel(owned_blocks(items, part, scan),
                                            work, devices, p.threads,
                                            device):
        if single:                 # ordered: pairs arrive in file order
            md5_1.update(raw1)
            md5_2.update(raw2)
        writer.add_block(gi, payload, BlockInfo(
            payload_len=len(payload), n_reads=n_pairs, raw_len1=len(raw1),
            raw_len2=len(raw2),
            flags=FLAG_PE | (FLAG_ALIGNED if was_aligned else 0),
            md5=hashlib.md5(raw1 + raw2).digest()))
        total_mapped += n_mapped
        total_reads += n_merged
        total_raw += len(raw1) + len(raw2)
        n_blocks += 1
    if rr2.take_rest():
        raise ValueError("PE inputs have different read counts")
    writer.input_md5s = [md5_1.digest(), md5_2.digest()]
    writer.finalize()
    out_size = os.path.getsize(out_path)
    dbg.add("raw_bytes", total_raw)
    dbg.add("out_bytes", out_size)
    return {"blocks": n_blocks, "raw": total_raw, "compressed": out_size,
            "ratio": total_raw / out_size if out_size else 0.0,
            "mapped": total_mapped, "reads": total_reads}


def _tally_pe_relations(align: AlignResult, dbg: DebugInfo) -> None:
    """Pair relations (both mapped, 1Y2N, 1N2Y, none) and the median
    insert over both-mapped pairs."""
    m1, m2 = align.mapped[0::2], align.mapped[1::2]
    dbg.add("pe_both_map", int((m1 & m2).sum()))
    dbg.add("pe_1Y2N", int((m1 & ~m2).sum()))
    dbg.add("pe_1N2Y", int((~m1 & m2).sum()))
    dbg.add("pe_none", int((~m1 & ~m2).sum()))
    both = m1 & m2
    if both.any():
        ins = np.abs(align.pos[0::2][both] - align.pos[1::2][both])
        dbg.add("pe_insert_median", float(np.median(ins)))
