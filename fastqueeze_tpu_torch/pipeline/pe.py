"""Paired-end compression and decompression.

Copied from fastqueeze_tpu/pipeline/pe.py: both mates of a pair live in
the same block, and the block coder sees them interleaved (r1_0, r2_0,
r1_1, ...), so one model serves both files and the ID binner turns the
alternating mates into step-0/step-1 columns.  Blocks are cut from file 1
at half the block size and file 2 is read by record count.  A PE block
payload is a JSON PE_META record {"fnl1", "fnl2"} (TAG 40) and the
interleaved body (TAG 41); its MD5 covers raw1 + raw2, and the archive
holds one whole-input MD5 per file.  Decode writes <prefix>_1.fastq and
<prefix>_2.fastq, or pipes per -P 1/2/3.

Compressing against a reference is pipeline/aligned.py
(compress_pe_aligned).  With -l both mates' qualities take the R-Block
transform before the block MD5.  ``part=(k, n)`` (--part K:N) writes the
partial archive of block pairs k, k+n, ... (driver.compress_se);
``--mesh N`` runs the block pairs data-parallel over N devices, as
driver.compress_se does, with the same archive.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import (
    FLAG_PE, ArcReader, ArcWriter, BlockInfo)
from fastqueeze_tpu_torch.container.encap import iter_tlv, write_tlv
from fastqueeze_tpu_torch.io.fastq import (
    FastqBlock, LazyLines, assemble_block, open_maybe_gz, parse_block,
    read_blocks)
from fastqueeze_tpu_torch.pipeline.blockcodec import (
    decode_block, encode_block)
from fastqueeze_tpu_torch.pipeline.driver import owned_blocks
from fastqueeze_tpu_torch.pipeline.lossy import lossy_pair
from fastqueeze_tpu_torch.pipeline.parallel_host import (
    block_dp_devices, device_parallel)
from fastqueeze_tpu_torch.utils.metrics import DebugInfo

TAG_PE_META = 40
TAG_PE_BODY = 41


def interleave_blocks(b1: FastqBlock, b2: FastqBlock) -> FastqBlock:
    """Merge mate blocks into pair-interleaved SoA (r1_0, r2_0, r1_1, ...)."""
    if b1.n_reads != b2.n_reads:
        raise ValueError(
            f"PE inputs disagree: {b1.n_reads} vs {b2.n_reads} reads in block")
    R = b1.n_reads
    lengths = np.empty(2 * R, np.int64)
    lengths[0::2] = b1.lengths
    lengths[1::2] = b2.lengths
    seq = _interleave_flat(b1.seq_flat, b1.lengths, b2.seq_flat, b2.lengths)
    qual = _interleave_flat(b1.qual_flat, b1.lengths, b2.qual_flat, b2.lengths)
    return FastqBlock(n_reads=2 * R, ids=_interleave_lines(b1.ids, b2.ids),
                      plus=_interleave_lines(b1.plus, b2.plus), seq_flat=seq,
                      qual_flat=qual, lengths=lengths,
                      raw_len=b1.raw_len + b2.raw_len,
                      final_newline=b1.final_newline and b2.final_newline)


def deinterleave_block(blk: FastqBlock, fnl1: bool, fnl2: bool
                       ) -> Tuple[FastqBlock, FastqBlock]:
    R = blk.n_reads // 2
    l1, l2 = blk.lengths[0::2], blk.lengths[1::2]
    s1, s2 = _deinterleave_flat(blk.seq_flat, l1, l2)
    q1, q2 = _deinterleave_flat(blk.qual_flat, l1, l2)
    b1 = FastqBlock(R, blk.ids[0::2], blk.plus[0::2], s1, q1, l1, 0, fnl1)
    b2 = FastqBlock(R, blk.ids[1::2], blk.plus[1::2], s2, q2, l2, 0, fnl2)
    return b1, b2


def _interleave_lines(a, b):
    """Pair-interleave two line collections; LazyLines inputs stay lazy
    (one flat copy, no per-line bytes objects)."""
    if isinstance(a, LazyLines) and isinstance(b, LazyLines):
        la, lb = np.diff(a.offs), np.diff(b.offs)
        lens = np.empty(2 * len(la), np.int64)
        lens[0::2] = la
        lens[1::2] = lb
        offs = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        cat = _interleave_flat(np.frombuffer(a.cat, np.uint8), la,
                               np.frombuffer(b.cat, np.uint8), lb)
        return LazyLines(cat.tobytes(), offs)
    return [x for pair in zip(a, b) for x in pair]


def _pair_offsets(l1: np.ndarray, l2: np.ndarray) -> np.ndarray:
    lens = np.empty(2 * len(l1), np.int64)
    lens[0::2] = l1
    lens[1::2] = l2
    return np.cumsum(lens) - lens


def _interleave_flat(f1, l1, f2, l2):
    out = np.empty(len(f1) + len(f2), np.uint8)
    off = _pair_offsets(l1, l2)
    _place(out, off[0::2], l1, f1)
    _place(out, off[1::2], l2, f2)
    return out


def _deinterleave_flat(flat, l1, l2):
    off = _pair_offsets(l1, l2)
    return _gather(flat, off[0::2], l1), _gather(flat, off[1::2], l2)


def _idx(starts, lens):
    total = int(lens.sum())
    return (np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(lens) - lens, lens)
            + np.repeat(starts, lens))


def _place(out, starts, lens, flat):
    if int(lens.sum()):
        out[_idx(starts, lens)] = flat


def _gather(flat, starts, lens):
    if not int(lens.sum()):
        return np.zeros(0, np.uint8)
    return flat[_idx(starts, lens)]


def pe_block_items(p: CodecParams, in1: str, rr2: "_RecordReader"):
    """(raw1, fnl1, raw2, fnl2) per block: file 1 cut at half the block
    size, file 2 taken by file 1's record count."""
    block_size = p.block_bytes or p.block_size_mb * (1 << 20)
    for raw1, fnl1 in read_blocks(in1, block_size // 2):
        n1 = (raw1.count(b"\n") + (0 if fnl1 else 1)) // 4
        raw2, fnl2 = rr2.take(n1)
        yield raw1, fnl1, raw2, fnl2


def pe_payload(b1: FastqBlock, b2: FastqBlock, body: bytes) -> bytes:
    meta = {"fnl1": b1.final_newline, "fnl2": b2.final_newline}
    return (write_tlv(TAG_PE_META, json.dumps(meta).encode())
            + write_tlv(TAG_PE_BODY, body))


def compress_pe(p: CodecParams, in1: str, in2: str, out_path: str,
                ref: Optional[str] = None, dbg: Optional[DebugInfo] = None,
                part: Optional[tuple] = None, device="cuda") -> Dict:
    dbg = dbg or DebugInfo()
    if ref:
        from fastqueeze_tpu_torch.pipeline.aligned import compress_pe_aligned
        return compress_pe_aligned(p, ref, in1, in2, out_path, dbg=dbg,
                                   part=part, device=device)
    devices = block_dp_devices(p, device)
    from fastqueeze_tpu_torch.pipeline.frozen import decide_use_model
    p.is_pe = 1
    md5_1, md5_2 = hashlib.md5(), hashlib.md5()
    writer = ArcWriter(out_path, p,
                       [os.path.basename(in1), os.path.basename(in2)], [],
                       part=part)
    frozen = None
    # the usemodel gate counts both files as they are (no .gz x5)
    if decide_use_model(p, os.path.getsize(in1) + os.path.getsize(in2)):
        frozen, blob = train_frozen_pe_prefix(p, in1, in2, device, dbg)
        writer.set_model(blob)
    rr2 = _RecordReader(in2)
    it = pe_block_items(p, in1, rr2)
    first = None
    if p.self_align == -1:
        # auto (-S default): decided once per file from the first pair
        from fastqueeze_tpu_torch.pipeline.selfref import auto_self_align
        first = next(it, None)
        sa = 0
        if first is not None:
            pb1 = parse_block(first[0], first[1])
            pb2 = parse_block(first[2], first[3])
            sa = 1 if auto_self_align(p, interleave_blocks(pb1, pb2),
                                      dbg) else 0
            first = first + (pb1, pb2)       # the encode reuses the parse
        p.self_align = sa

    def items():
        if first is not None:
            yield first
        for item in it:
            yield item + (None, None)

    single = not part or part[1] == 1

    def scan(item):
        raw1, fnl1, raw2, fnl2, b1, b2 = item
        if p.lossy_factor > 1.0:
            if b1 is None:
                b1 = parse_block(raw1, fnl1)
                b2 = parse_block(raw2, fnl2)
            raw1, b1, raw2, b2 = lossy_pair(p, raw1, b1, raw2, b2)
        md5_1.update(raw1)
        md5_2.update(raw2)
        return raw1, fnl1, raw2, fnl2, b1, b2

    def work(_i, gi_item, device):
        gi, (raw1, fnl1, raw2, fnl2, b1, b2) = gi_item
        if b1 is None:
            b1 = parse_block(raw1, fnl1)
            b2 = parse_block(raw2, fnl2)
        if single:
            # -l after the auto probe, which saw the first pair as read
            raw1, b1, raw2, b2 = lossy_pair(p, raw1, b1, raw2, b2)
        merged = interleave_blocks(b1, b2)
        align = rc = None
        if p.self_align:
            from fastqueeze_tpu_torch.pipeline.selfref import maybe_align_self
            align, rc = maybe_align_self(p, merged, dbg)
        t0 = time.time()
        body = encode_block(p, merged, frozen, device, dbg, align, rc,
                            self_ref=align is not None)
        dbg.add("encode_s", time.time() - t0)
        return gi, raw1, raw2, pe_payload(b1, b2, body), b1.n_reads

    n_blocks = total_raw = 0
    for _, (gi, raw1, raw2, payload, n_pairs) in device_parallel(
            owned_blocks(items(), part, scan), work, devices, p.threads,
            device):
        if single:                 # ordered: pairs arrive in file order
            md5_1.update(raw1)
            md5_2.update(raw2)
        writer.add_block(gi, payload, BlockInfo(
            payload_len=len(payload), n_reads=n_pairs, raw_len1=len(raw1),
            raw_len2=len(raw2), flags=FLAG_PE,
            md5=hashlib.md5(raw1 + raw2).digest()))
        dbg.add("reads", 2 * n_pairs)
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
            "ratio": total_raw / out_size if out_size else 0.0}


class _RecordReader:
    """Sequential exact-record-count reader over a (possibly gz) FASTQ."""

    def __init__(self, path: str):
        self._fh, _ = open_maybe_gz(path)
        self._carry = b""
        self._eof = False

    def take(self, n_records: int) -> Tuple[bytes, bool]:
        need = 4 * n_records
        have = self._carry.count(b"\n")
        chunks = [self._carry]
        while have < need and not self._eof:
            data = self._fh.read(1 << 20)
            if not data:
                self._eof = True
                break
            chunks.append(data)
            have += data.count(b"\n")
        buf = b"".join(chunks)
        if have < need:
            # a final record without its trailing newline
            if have == need - 1 and buf and not buf.endswith(b"\n"):
                self._carry = b""
                return buf, False
            raise ValueError("PE file 2 ran out of records")
        pos = -1
        for _ in range(need):
            pos = buf.index(b"\n", pos + 1)
        self._carry = buf[pos + 1:]
        return buf[:pos + 1], True

    def take_rest(self) -> bytes:
        rest = self._carry + self._fh.read()
        self._fh.close()
        return rest


def train_frozen_pe_prefix(p: CodecParams, in1: str, in2: str, device,
                           dbg: DebugInfo):
    """usemodel preprocess over the pair: model_train_mb/2 from each file,
    trained interleaved (the stream shape the block coder sees), the
    symbol estimate scaled over both files; the tables are quantized on
    ``device``.  Returns (frozen, serialized blob)."""
    from fastqueeze_tpu_torch.pipeline.blockcodec import dedup_training_block
    from fastqueeze_tpu_torch.pipeline.frozen import (
        serialize_frozen, stage_tables, train_frozen_blocks)
    t0 = time.time()
    half = (p.model_train_mb << 20) // 2
    b1 = parse_block(*next(iter(read_blocks(in1, half))))
    rr2 = _RecordReader(in2)
    b2 = parse_block(*rr2.take(b1.n_reads))
    rr2.take_rest()
    _, b1, _, b2 = lossy_pair(p, b"", b1, b"", b2)
    merged = interleave_blocks(b1, b2)
    prefix_syms = int(merged.lengths.sum())
    total = os.path.getsize(in1) + os.path.getsize(in2)
    est = (int(total * prefix_syms / max(b1.raw_len + b2.raw_len, 1))
           if (b1.raw_len and b2.raw_len) else prefix_syms)
    if p.dedup:
        merged, frac = dedup_training_block(merged, p)
        est = int(est * frac)
    frozen = train_frozen_blocks(p, [merged], est_total_syms=est)
    stage_tables(frozen, p, device)
    dbg.add("train_s", time.time() - t0)
    return frozen, serialize_frozen(frozen)


def decode_pe_payload(p: CodecParams, payload: bytes, frozen, ref_codes,
                      expected_md5: bytes, block_idx: int, device):
    """Decode and verify one PE block payload (PE_META wrapper,
    interleaved body, MD5 over raw1 + raw2)."""
    sections = dict(iter_tlv(payload))
    meta = json.loads(sections[TAG_PE_META].decode())
    merged = decode_block(p, sections[TAG_PE_BODY], frozen, device,
                          ref_codes)
    b1, b2 = deinterleave_block(merged, meta["fnl1"], meta["fnl2"])
    raw1, raw2 = assemble_block(b1), assemble_block(b2)
    if hashlib.md5(raw1 + raw2).digest() != expected_md5:
        raise ValueError(f"block {block_idx}: MD5 mismatch (corrupt archive)")
    return b1, b2, raw1, raw2


def decompress_pe_blocks(reader: ArcReader, out_prefix: Optional[str],
                         dbg: DebugInfo, device, pipeout: int = 0,
                         force: bool = False, ref_codes=None,
                         devices=None) -> List[str]:
    p = reader.params
    names = _pe_out_names(reader, out_prefix)
    md5_1, md5_2 = hashlib.md5(), hashlib.md5()
    if pipeout:
        o1 = sys.stdout.buffer if pipeout in (1, 3) else None
        o2 = sys.stdout.buffer if pipeout in (2, 3) else None
    else:
        for n in names:
            if os.path.exists(n) and not force:
                raise ValueError(f"{n} exists (use -f to overwrite)")
        o1 = open(names[0], "wb")
        o2 = open(names[1], "wb")
    frozen = None
    if reader.model_blob is not None:
        from fastqueeze_tpu_torch.pipeline.frozen import deserialize_frozen
        frozen = deserialize_frozen(reader.model_blob)

    def decode_one(i, payload, device):
        return decode_pe_payload(p, payload, frozen, ref_codes,
                                 reader.blocks[i].md5, i, device)

    try:
        payloads = (reader.read_block(i) for i in range(len(reader.blocks)))
        t0 = time.time()
        for _, (b1, b2, raw1, raw2) in device_parallel(
                payloads, decode_one, devices, p.threads, device):
            md5_1.update(raw1)
            md5_2.update(raw2)
            if pipeout == 3:
                _write_interleaved(sys.stdout.buffer, b1, b2)
            else:
                if o1 is not None:
                    o1.write(raw1)
                if o2 is not None:
                    o2.write(raw2)
        dbg.add("decode_s", time.time() - t0)
        if len(reader.input_md5s) == 2 and not pipeout:
            if (md5_1.digest() != reader.input_md5s[0]
                    or md5_2.digest() != reader.input_md5s[1]):
                raise ValueError("whole-input MD5 mismatch")
    finally:
        if not pipeout:
            o1.close()
            o2.close()
    return names if not pipeout else []


def _write_interleaved(out, b1: FastqBlock, b2: FastqBlock) -> None:
    offs = [np.concatenate(([0], np.cumsum(b.lengths, dtype=np.int64)))
            for b in (b1, b2)]
    for k in range(b1.n_reads):
        for b, off in zip((b1, b2), offs):
            s, e = int(off[k]), int(off[k + 1])
            out.write(b"@" + b.ids[k] + b"\n" + b.seq_flat[s:e].tobytes()
                      + b"\n+" + b.plus[k] + b"\n" + b.qual_flat[s:e].tobytes()
                      + b"\n")


def _pe_out_names(reader: ArcReader, out_prefix: Optional[str]) -> List[str]:
    if out_prefix:
        return [f"{out_prefix}_1.fastq", f"{out_prefix}_2.fastq"]
    if len(reader.file_list) == 2:
        return list(reader.file_list)
    base = reader.path
    return [base + "_1.fastq", base + "_2.fastq"]
