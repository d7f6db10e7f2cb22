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

compress_pe runs driver.compress_blocks, compress_se's loop, over
:class:`PairedEnd`'s block pairs, so ``part=(k, n)`` (--part K:N: the
partial archive of block pairs k, k+n, ...), ``--mesh N`` (block pairs
data-parallel over N devices, the same archive), -t and the -S auto
probe behave as for single-end input.  Compressing against a reference
is pipeline/aligned.py (compress_pe_aligned).  With -l both mates'
qualities take the R-Block transform before the block MD5.  Stages:
``pe.mate2`` (file 2's records of a block pair, inside ``read``),
``pe.interleave`` (the mates into the coder's block) and, on decode,
``pe.deinterleave``; the counter ``pairs`` beside ``reads``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import FLAG_PE, ArcReader
from fastqueeze_tpu_torch.container.encap import iter_tlv, write_tlv
from fastqueeze_tpu_torch.io import native
from fastqueeze_tpu_torch.io.fastq import (
    FastqBlock, LazyLines, _line_lens, assemble_block, open_maybe_gz,
    parse_block, read_blocks)
from fastqueeze_tpu_torch.pipeline.blockcodec import decode_block
from fastqueeze_tpu_torch.pipeline.driver import (
    Block, block_bytes, compress_blocks)
from fastqueeze_tpu_torch.pipeline.lossy import lossy_pair, lossy_quals
from fastqueeze_tpu_torch.pipeline.parallel_host import device_parallel
from fastqueeze_tpu_torch.utils.metrics import DebugInfo, stage

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


# the mates' bases and qualities move read by read through the native
# library's copies (io/native.py, the parser's); NumPy indexes every byte
# where it is missing
def _place(out, starts, lens, flat):
    if int(lens.sum()) and not native.scatter(flat, starts, lens, out):
        out[_idx(starts, lens)] = flat


def _gather(flat, starts, lens):
    total = int(lens.sum())
    if not total:
        return np.zeros(0, np.uint8)
    flat = np.ascontiguousarray(flat, np.uint8)
    out = native.gather(flat, starts, starts + lens, total)
    return out if out is not None else flat[_idx(starts, lens)]


def pe_block_items(p: CodecParams, in1: str, rr2: "_RecordReader",
                   dbg: Optional[DebugInfo] = None):
    """(raw1, fnl1, raw2, fnl2) per block: file 1 cut at half the block
    size, file 2 taken by file 1's record count (the stage ``pe.mate2``)."""
    for raw1, fnl1 in read_blocks(in1, block_bytes(p) // 2):
        n1 = (raw1.count(b"\n") + (0 if fnl1 else 1)) // 4
        with stage(dbg, "pe.mate2"):
            raw2, fnl2 = rr2.take(n1)
        yield raw1, fnl1, raw2, fnl2


def pe_payload(fnl1: bool, fnl2: bool, body: bytes) -> bytes:
    meta = {"fnl1": fnl1, "fnl2": fnl2}
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
    p.is_pe = 1
    return compress_blocks(p, PairedEnd(p, in1, in2, dbg), out_path, dbg,
                           part, device)


class PairedEnd:
    """compress_pe's input for driver.compress_blocks: block pairs
    (pe_block_items), each parsed mate by mate, then -l's transform on
    both and the mates interleaved into the coder's block.  The -S auto
    probe sees the first pair as read (before -l); the frozen tables
    train on file 1's first model_train_mb / 2 MB and the same records
    of file 2 (:func:`train_pairs`), taken from the block pairs that the
    encode loop then reuses."""
    flags = FLAG_PE

    def __init__(self, p: CodecParams, in1: str, in2: str, dbg: DebugInfo):
        self.params, self.paths, self.dbg = p, [in1, in2], dbg
        self._rr2 = None

    def gate_bytes(self) -> int:
        # the usemodel gate counts both files as they are (no .gz x5)
        return sum(map(os.path.getsize, self.paths))

    def blocks(self):
        self._rr2 = _RecordReader(self.paths[1])
        for raw1, fnl1, raw2, fnl2 in pe_block_items(
                self.params, self.paths[0], self._rr2, self.dbg):
            yield Block((raw1, raw2), (fnl1, fnl2))

    def parse_first(self, b: Block) -> None:
        b.mates = (parse_block(b.raws[0], b.fnls[0]),
                   parse_block(b.raws[1], b.fnls[1]))

    def parse(self, b: Block) -> None:
        if b.mates is None:
            self.parse_first(b)
        raw1, b1, raw2, b2 = lossy_pair(self.params, b.raws[0], b.mates[0],
                                        b.raws[1], b.mates[1])
        b.raws, b.mates = (raw1, raw2), (b1, b2)
        b.block = self._interleave(b1, b2)

    def _interleave(self, b1: FastqBlock, b2: FastqBlock) -> FastqBlock:
        with self.dbg.span("pe.interleave"):
            return interleave_blocks(b1, b2)

    def probe_block(self, b: Block) -> FastqBlock:
        merged = self._interleave(*b.mates)
        if self.params.lossy_factor <= 1.0:
            b.block = merged        # the coder's block as well
        return merged

    def payload(self, fnls: tuple, body: bytes) -> bytes:
        return pe_payload(*fnls, body)

    def train(self, blocks, prefix: List[Block], device) -> Dict:
        """Pull block pairs into ``prefix`` until they hold the training
        prefix, parse their mates once, and train on its records."""
        dbg = self.dbg
        with dbg.span("train"):
            n = _prefix_records(self.params, blocks, prefix)
            with dbg.span("train.parse"):
                for b in prefix:
                    self.parse_first(b)
            b1 = _head([b.mates[0] for b in prefix], n)
            b2 = _head([b.mates[1] for b in prefix], n)
            return train_pairs(self.params, b1, b2, self.gate_bytes(), device,
                               dbg)

    def end(self) -> None:
        if self._rr2 is not None and self._rr2.take_rest():
            raise ValueError("PE inputs have different read counts")


def _prefix_records(p: CodecParams, blocks, prefix: List[Block]) -> int:
    """Pull block pairs from ``blocks`` into ``prefix`` until they hold
    the records of file 1 that read_blocks(in1, model_train_mb / 2 MB)
    gives as its first block (the records whole within its first chunk
    that holds one; the whole file where none does), and return their
    count."""
    half = (p.model_train_mb << 20) // 2
    if half <= 0:
        raise ValueError(f"model_train_mb {p.model_train_mb}: no prefix")
    got, chunk, end = 0, half, False
    while True:
        while got < chunk and not end:
            b = next(blocks, None)
            if b is None:
                end = True
            else:
                prefix.append(b)
                got += len(b.raws[0])
        lines, left = 0, chunk
        for b in prefix:
            if left <= 0:
                break
            lines += b.raws[0].count(b"\n", 0, left)
            left -= len(b.raws[0])
        if lines >= 4:
            return lines // 4
        if end:
            return sum((b.raws[0].count(b"\n") + (0 if b.fnls[0] else 1))
                       // 4 for b in prefix)
        chunk += half


def _head(blocks: List[FastqBlock], n: int) -> FastqBlock:
    """The first ``n`` records of ``blocks`` (in order) as a new block of
    what training reads: bases, qualities, lengths and the plaintext
    size (no IDs)."""
    seq, qual, lens = [], [], []
    raw_len, fnl = 0, True
    for b in blocks:
        k = min(n, b.n_reads)
        if k <= 0:
            break
        n -= k
        s = int(b.lengths[:k].sum())
        seq.append(b.seq_flat[:s])
        qual.append(b.qual_flat[:s])
        lens.append(b.lengths[:k])
        if k == b.n_reads:
            raw_len += b.raw_len
            fnl = b.final_newline
        else:
            raw_len += int((_line_lens(b.ids, b.n_reads)[:k]
                            + _line_lens(b.plus, b.n_reads)[:k]
                            + 2 * b.lengths[:k] + 6).sum())
            fnl = True
    lens = np.concatenate(lens)
    return FastqBlock(n_reads=len(lens), ids=[], plus=[],
                      seq_flat=np.concatenate(seq),
                      qual_flat=np.concatenate(qual), lengths=lens,
                      raw_len=raw_len, final_newline=fnl)


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
        pos = (int(np.flatnonzero(np.frombuffer(buf, np.uint8) == 10)
                   [need - 1]) if need else -1)
        self._carry = buf[pos + 1:]
        return buf[:pos + 1], True

    def take_rest(self) -> bytes:
        rest = self._carry + self._fh.read()
        self._fh.close()
        return rest


def train_frozen_pe_prefix(p: CodecParams, in1: str, in2: str, device,
                           dbg: DebugInfo) -> Dict:
    """usemodel preprocess of the aligned PE path over the pair:
    model_train_mb/2 from file 1 and the same records of file 2, read
    and parsed here (:func:`train_pairs`)."""
    with dbg.span("train"):
        half = (p.model_train_mb << 20) // 2
        with dbg.span("train.parse"):
            b1 = parse_block(*next(iter(read_blocks(in1, half))))
            rr2 = _RecordReader(in2)
            b2 = parse_block(*rr2.take(b1.n_reads))
            rr2.take_rest()
        return train_pairs(p, b1, b2, os.path.getsize(in1)
                           + os.path.getsize(in2), device, dbg)


def train_pairs(p: CodecParams, b1: FastqBlock, b2: FastqBlock,
                total: int, device, dbg: DebugInfo) -> Dict:
    """The frozen tables trained on the prefix pair (b1, b2), which the
    caller owns: -l's transform, the mates interleaved (the stream shape
    the block coder sees), the symbol estimate scaled over both files'
    ``total`` bytes; the tables are quantized on ``device``.  Their packs
    run on the packing thread, which serialize_frozen joins."""
    from fastqueeze_tpu_torch.pipeline.blockcodec import dedup_training_block
    from fastqueeze_tpu_torch.pipeline.frozen import (
        stage_tables, train_frozen_blocks)
    lossy_quals(p, b1)
    lossy_quals(p, b2)
    with dbg.span("pe.interleave"):
        merged = interleave_blocks(b1, b2)
    prefix_syms = int(merged.lengths.sum())
    est = (int(total * prefix_syms / max(b1.raw_len + b2.raw_len, 1))
           if (b1.raw_len and b2.raw_len) else prefix_syms)
    if p.dedup:
        with dbg.span("train.dedup"):
            merged, frac = dedup_training_block(merged, p)
        est = int(est * frac)
    frozen = train_frozen_blocks(p, [merged], est_total_syms=est,
                                 device=device)
    with dbg.span("train.stage"):
        stage_tables(frozen, p, device)
    return frozen


def decode_pe_payload(p: CodecParams, payload: bytes, frozen, ref_codes,
                      expected_md5: bytes, block_idx: int, device,
                      dbg: Optional[DebugInfo] = None):
    """Decode and verify one PE block payload (PE_META wrapper,
    interleaved body, MD5 over raw1 + raw2)."""
    sections = dict(iter_tlv(payload))
    meta = json.loads(sections[TAG_PE_META].decode())
    merged = decode_block(p, sections[TAG_PE_BODY], frozen, device,
                          ref_codes, dbg=dbg)
    with stage(dbg, "pe.deinterleave"):
        b1, b2 = deinterleave_block(merged, meta["fnl1"], meta["fnl2"])
    with stage(dbg, "assemble"):
        raw1, raw2 = assemble_block(b1), assemble_block(b2)
    with stage(dbg, "md5"):
        md5 = hashlib.md5(raw1)
        md5.update(raw2)
    if md5.digest() != expected_md5:
        raise ValueError(f"block {block_idx}: MD5 mismatch (corrupt archive)")
    return b1, b2, raw1, raw2


def decompress_pe_blocks(reader: ArcReader, out_prefix: Optional[str],
                         dbg: DebugInfo, device, pipeout: int = 0,
                         force: bool = False, ref_codes=None,
                         devices=None) -> List[str]:
    from fastqueeze_tpu_torch.pipeline.driver import _frozen_of, _spanned
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
    try:
        frozen = _frozen_of(reader, dbg)

        def decode_one(i, payload, device):
            return decode_pe_payload(p, payload, frozen, ref_codes,
                                     reader.blocks[i].md5, i, device, dbg)

        payloads = _spanned((reader.read_block(i)
                             for i in range(len(reader.blocks))), dbg, "read")
        with dbg.span("decode"):
            for _, (b1, b2, raw1, raw2) in device_parallel(
                    payloads, decode_one, devices, p.threads, device):
                with dbg.span("md5"):
                    md5_1.update(raw1)
                    md5_2.update(raw2)
                with dbg.span("write"):
                    if pipeout == 3:
                        _write_interleaved(sys.stdout.buffer, b1, b2)
                    else:
                        if o1 is not None:
                            o1.write(raw1)
                        if o2 is not None:
                            o2.write(raw2)
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
