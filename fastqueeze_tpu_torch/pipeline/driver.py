"""File-level compress/decompress orchestration.

Copied from fastqueeze_tpu/pipeline/driver.py: cut the input into blocks,
train the frozen tables on a prefix when the usemodel gate says so (else
every block codes adaptively and the archive has no model), encode each
block, record per-block MD5 + whole-input MD5, write the container; on
decode, verify both and reassemble the plaintext.  Every stage takes the
engine's ``device`` explicitly.

Self-referential blocks (auto probe or -S) are coded here; compressing
against a reference FASTA is pipeline/aligned.py.  :func:`compress_blocks`
is the compress loop of single-end (:class:`SingleEnd`) and paired-end
input (pipeline/pe.py PairedEnd: its blocks, their parse and training
prefix, its payloads), and decompress takes the FASTA (``ref``) and sends PE
archives to pe.decompress_pe_blocks.  With lossy_factor > 1 (-l) every
block's qualities take the R-Block transform before its MD5 (and the
training prefix before training).  ``part=(k, n)`` (--part K:N) writes
the partial archive of blocks k, k+n, ... (container/arcfile.py
merge_archives assembles the parts); :func:`extract` (-X) decodes only
the blocks covering a read range; :func:`compress_multi` (-m) puts
several inputs into one archive.  --mesh N round-robins whole blocks
over N devices (block data-parallelism, pipeline/parallel_host.py); on
decode a mesh with a frozen quality table of at least
CTX_SHARD_MIN_ENTRIES entries decodes that table sharded by rows over
the mesh instead (parallel/mesh.py, K18).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import (
    ArcReader, ArcWriter, BlockInfo)
from fastqueeze_tpu_torch.io.fastq import assemble_block, read_blocks
from fastqueeze_tpu_torch.pipeline.blockcodec import (
    decode_block, encode_block, encode_block_job)
from fastqueeze_tpu_torch.parallel.mesh import block_devices
from fastqueeze_tpu_torch.pipeline.lossy import parse_lossy
from fastqueeze_tpu_torch.pipeline.parallel_host import (
    block_dp_devices, device_parallel)
from fastqueeze_tpu_torch.utils.metrics import DebugInfo, stage

# Frozen qual tables with at least this many (rows x (A+1)) entries decode
# ctx-sharded over an active mesh instead of copied to every device (the
# 2^20-row deep-qctx tables with a 40-rank alphabet sit at ~44 M).  Tests
# monkeypatch it to run the path at toy scale.
CTX_SHARD_MIN_ENTRIES = 32 << 20


def _reject_partial(reader: ArcReader, arc_path: str) -> None:
    if reader.part is not None:
        k, n = reader.part
        raise ValueError(
            f"{arc_path}: partial archive (part {k} of {n}) — assemble the "
            f"full archive first: fastqueeze --merge part0.fqz ... -o out.fqz")


def owned_blocks(items, part: Optional[tuple], scan):
    """(block index, item) of the blocks that ``part`` (k, n) owns: k,
    k+n, ... (--part K:N; all of them without a part).  With n > 1 every
    item first goes through ``scan``, which -l transforms it where needed
    and adds it to the whole-input MD5s, in file order: so each part
    hashes the whole input and the merged parts equal the single-run
    archive.  (A single run hashes its blocks as they come back.)"""
    k, n = part if part else (0, 1)
    for gi, item in enumerate(items):
        if n > 1:
            item = scan(item)
            if gi % n != k:
                continue
        yield gi, item


_END = object()


def _spanned(items, dbg: DebugInfo, name: str):
    """``items`` with each pull timed as the stage ``name`` (the reads of
    a lazy block reader)."""
    it = iter(items)
    while True:
        with dbg.span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def _gate_bytes(in_path: str) -> int:
    """usemodel gate input-size estimate; gz inputs scale x5 (the
    reference's heuristic, doCheckSetEncodeOpt @0x408298)."""
    sz = os.path.getsize(in_path)
    return sz * 5 if in_path.endswith(".gz") else sz


def block_bytes(params: CodecParams) -> int:
    return params.block_bytes or params.block_size_mb * (1 << 20)


def _update_md5s(md5s, raws) -> None:
    """Each input file's whole-input MD5 by the block's plaintext of that
    file."""
    for h, raw in zip(md5s, raws):
        h.update(raw)


class Block:
    """One block of the input as the compress loop carries it: the
    plaintext it holds of each input file (``raws``: one file SE, two PE)
    and their final-newline flags; once parsed, each file's records
    (``mates``) and the block the coder takes (``block``: SE the file's
    records, PE the mates interleaved)."""
    __slots__ = ("raws", "fnls", "mates", "block")

    def __init__(self, raws: tuple, fnls: tuple):
        self.raws, self.fnls = raws, fnls
        self.mates = self.block = None


class SingleEnd:
    """compress_se's input: one FASTQ file cut into blocks of whole
    records.  A block is parsed with -l's transform into the coder's
    block; the frozen tables train on the whole blocks that cover the
    first model_train_mb MB (reference doPreProcess)."""
    flags = 0

    def __init__(self, params: CodecParams, path: str, dbg: DebugInfo):
        self.params, self.paths, self.dbg = params, [path], dbg

    def gate_bytes(self) -> int:
        return _gate_bytes(self.paths[0])

    def blocks(self):
        for raw, final_nl in read_blocks(self.paths[0],
                                         block_bytes(self.params)):
            yield Block((raw,), (final_nl,))

    def parse(self, b: Block) -> None:
        raw, block = parse_lossy(self.params, b.raws[0], b.fnls[0])
        b.raws, b.mates, b.block = (raw,), (block,), block

    parse_first = parse

    def probe_block(self, b: Block):
        return b.block

    def payload(self, fnls: tuple, body: bytes) -> bytes:
        return body

    def train(self, blocks, prefix: List[Block], device) -> Dict:
        """Pull blocks until the training prefix is covered, parse them
        once into ``prefix`` (the encode loop reuses them), train the
        frozen tables from the parsed arrays (their candidates scored on
        ``device`` where it is a card) and upload them to ``device``."""
        from fastqueeze_tpu_torch.pipeline.blockcodec import (
            dedup_training_block)
        from fastqueeze_tpu_torch.pipeline.frozen import (
            stage_tables, train_frozen_blocks)
        params, dbg = self.params, self.dbg
        with dbg.span("train"):
            need = params.model_train_mb << 20
            got = 0
            for b in blocks:
                with dbg.span("train.parse"):
                    self.parse(b)
                prefix.append(b)
                got += len(b.raws[0])
                if got >= need:
                    break
            tblocks = [b.block for b in prefix]
            syms = sum(int(t.lengths.sum()) for t in tblocks)
            est = int(self.gate_bytes() * syms / max(got, 1))
            if params.dedup:
                # train on the deduped sample (what the coder will emit) so
                # the qctx cost model prices tables honestly
                with dbg.span("train.dedup"):
                    tblocks = [dedup_training_block(t, params)[0]
                               for t in tblocks]
                uq = sum(int(t.lengths.sum()) for t in tblocks)
                est = int(est * uq / max(syms, 1))
            frozen = train_frozen_blocks(params, tblocks, est_total_syms=est,
                                         device=device)
            with dbg.span("train.stage"):
                stage_tables(frozen, params, device)
        return frozen

    def end(self) -> None:
        pass


def train_frozen_prefix(p: CodecParams, in_path: str, device,
                        dbg: DebugInfo):
    """usemodel preprocess of the aligned and multi-file paths (the JAX
    package's driver.train_frozen_prefix): frozen tables trained on the
    input's first model_train_mb MB as one block, quantized on
    ``device``.  Returns (frozen, serialized blob)."""
    from fastqueeze_tpu_torch.pipeline.blockcodec import dedup_training_block
    from fastqueeze_tpu_torch.pipeline.frozen import (
        serialize_frozen, stage_tables, train_frozen)
    with dbg.span("train"):
        _, block = parse_lossy(p, *next(iter(read_blocks(
            in_path, p.model_train_mb << 20))))
        est = int(_gate_bytes(in_path) * int(block.lengths.sum())
                  / max(block.raw_len, 1))
        if p.dedup:
            block, frac = dedup_training_block(block, p)
            est = int(est * frac)
        frozen = train_frozen(p, block, est_total_syms=est, device=device)
        stage_tables(frozen, p, device)
    return frozen, serialize_frozen(frozen)


def compress_se(params: CodecParams, in_path: str, out_path: str,
                dbg: Optional[DebugInfo] = None,
                part: Optional[tuple] = None, device="cuda") -> Dict:
    dbg = dbg or DebugInfo()
    return compress_blocks(params, SingleEnd(params, in_path, dbg),
                           out_path, dbg, part, device)


def compress_blocks(params: CodecParams, src, out_path: str, dbg: DebugInfo,
                    part: Optional[tuple] = None, device="cuda") -> Dict:
    """The compress loop of every input kind (``src``: :class:`SingleEnd`
    or pe.PairedEnd): the frozen tables trained when the usemodel gate
    says so, the -S auto probe on the first block, then each block parsed,
    dispatched and finalized into the archive with its MD5 over its
    plaintext of every file, and one whole-input MD5 a file.  At -t 1 block
    i+1 is read, parsed and dispatched before block i is finalized; with
    more threads (or --mesh) whole blocks run on the host pipeline.  The
    frozen tables' packing thread is joined just before the archive is
    written."""
    devices = block_dp_devices(params, device)
    from fastqueeze_tpu_torch.pipeline.frozen import (
        decide_use_model, join_packing, serialize_frozen)
    md5s = [hashlib.md5() for _ in src.paths]
    blocks = _spanned(src.blocks(), dbg, "read")
    frozen = None
    prefix: List[Block] = []    # parsed once (training, probe), reused
    if decide_use_model(params, src.gate_bytes()):
        frozen = src.train(blocks, prefix, device)

    try:
        if params.self_align == -1:
            # auto (-S default): decided once per file from the first block;
            # the answer is written into PARAM
            from fastqueeze_tpu_torch.pipeline.selfref import auto_self_align
            if not prefix:
                first = next(blocks, None)
                if first is not None:
                    # parsed once for the probe, reused by the encode loop
                    with dbg.span("first_block"):
                        src.parse_first(first)
                    prefix.append(first)
            with dbg.span("probe"):
                params.self_align = 1 if (
                    prefix and auto_self_align(
                        params, src.probe_block(prefix[0]), dbg)) else 0
        writer = ArcWriter(out_path, params,
                           [os.path.basename(x) for x in src.paths], [],
                           part=part)
        single = not part or part[1] == 1

        def items():
            while prefix:
                yield prefix.pop(0)
            yield from blocks

        def scan(b):
            if b.block is None and params.lossy_factor > 1.0:
                src.parse(b)
            _update_md5s(md5s, b.raws)
            return b

        def encode_job(block, device):
            align = ref_codes = None
            if params.self_align:
                from fastqueeze_tpu_torch.pipeline.selfref import (
                    maybe_align_self)
                align, ref_codes = maybe_align_self(params, block, dbg)
            return encode_block_job(params, block, frozen, device, dbg, align,
                                    ref_codes, self_ref=align is not None)

        def info(raws, n_reads):
            md5 = hashlib.md5()
            for raw in raws:
                md5.update(raw)
            return BlockInfo(payload_len=0, n_reads=n_reads,
                             raw_len1=len(raws[0]),
                             raw_len2=len(raws[1]) if len(raws) > 1 else 0,
                             flags=src.flags, md5=md5.digest())

        def tally(raws, n_reads):
            dbg.add("reads", n_reads * len(raws))
            if len(raws) > 1:
                dbg.add("pairs", n_reads)
            return sum(map(len, raws))

        n_blocks = total_raw = 0
        if params.threads > 1:
            def work(_i, gi_b, device):
                gi, b = gi_b
                if b.block is None:
                    src.parse(b)
                payload = src.payload(b.fnls, encode_job(b.block, device)())
                return gi, b.raws, b.mates[0].n_reads, payload

            with dbg.span("encode"):
                for _, (gi, raws, n_reads, payload) in device_parallel(
                        owned_blocks(items(), part, scan), work, devices,
                        params.threads, device):
                    with dbg.span("md5"):
                        if single:     # ordered: blocks arrive in file order
                            _update_md5s(md5s, raws)
                        inf = info(raws, n_reads)
                    with dbg.span("write"):
                        writer.add_block(gi, payload, inf)
                    total_raw += tally(raws, n_reads)
                    n_blocks += 1
        else:
            pending = None      # (idx, finalize, fnls, BlockInfo): in flight

            def flush(pend):
                gi, fin, fnls, inf = pend
                with dbg.span("encode"):
                    payload = src.payload(fnls, fin())
                with dbg.span("write"):
                    writer.add_block(gi, payload, inf)

            for gi, b in owned_blocks(items(), part, scan):
                with dbg.span("parse"):
                    if b.block is None:
                        src.parse(b)
                    if single:
                        with dbg.span("parse.md5"):
                            _update_md5s(md5s, b.raws)
                with dbg.span("dispatch"):
                    fin = encode_job(b.block, device)
                n_reads = b.mates[0].n_reads
                with dbg.span("md5"):
                    inf = info(b.raws, n_reads)
                if pending is not None:
                    flush(pending)
                pending = (gi, fin, b.fnls, inf)
                total_raw += tally(b.raws, n_reads)
                n_blocks += 1
            if pending is not None:
                flush(pending)
        src.end()
        if frozen is not None:
            # the tables' packs ran beside the training and the blocks
            with dbg.span("serialize"):
                writer.set_model(serialize_frozen(frozen))
        writer.input_md5s = [h.digest() for h in md5s]
        with dbg.span("write"):
            writer.finalize()
    finally:
        join_packing(frozen)    # no packing thread outlives the call
    out_size = os.path.getsize(out_path)
    dbg.add("raw_bytes", total_raw)
    dbg.add("out_bytes", out_size)
    return {"blocks": n_blocks, "raw": total_raw, "compressed": out_size,
            "ratio": total_raw / out_size if out_size else 0.0}


def decompress(arc_path: str, out_prefix: Optional[str],
               dbg: Optional[DebugInfo] = None, force: bool = False,
               threads: int = 0, device="cuda", ref: Optional[str] = None,
               pipeout: int = 0, mesh: int = 0,
               indir: bool = False) -> List[str]:
    """ref: the reference FASTA of a reference-aligned archive.  pipeout
    (-P): write the reads to stdout instead of files; PE archives take 1
    (file 1), 2 (file 2) or 3 (pairs interleaved).  mesh (--mesh)
    overrides the encoder's mesh_n; either is clamped to the visible
    devices of ``device``'s kind.  indir (-p): an SE output goes next to
    the archive."""
    dbg = dbg or DebugInfo()
    with ArcReader(arc_path) as reader:
        _reject_partial(reader, arc_path)
        params = reader.params
        if threads:            # decode-side -t overrides the encoder's
            params.threads = threads
        if mesh:
            params.mesh_n = mesh
        devices = block_devices(params.mesh_n, clamp=True,
                                kind=torch.device(device).type)
        if devices and params.threads < len(devices):
            params.threads = len(devices)
        ref_codes = _load_ref_for_decode(params, ref)
        if params.is_pe:
            from fastqueeze_tpu_torch.pipeline.pe import decompress_pe_blocks
            return decompress_pe_blocks(reader, out_prefix, dbg, device,
                                        pipeout=pipeout, force=force,
                                        ref_codes=ref_codes, devices=devices)
        if getattr(params, "multi", 0):
            return _decompress_multi(reader, out_prefix, dbg,
                                     _frozen_of(reader, dbg), ref_codes,
                                     force, device, devices)
        out_name = _se_out_name(arc_path, out_prefix, reader.file_list)
        if indir:
            out_name = os.path.join(os.path.dirname(os.path.abspath(arc_path)),
                                    os.path.basename(out_name))
        if pipeout:
            out_name = None
        elif os.path.exists(out_name) and not force:
            raise ValueError(f"{out_name} exists (use -f to overwrite)")
        frozen = _frozen_of(reader, dbg)
        # big-table gate: with a mesh and a frozen qual table past the
        # copy threshold, blocks decode on ``device`` with that table
        # sharded by rows over the mesh's devices (K18) instead of copied
        # to each device for block round-robin
        ctx_shard = None
        if (devices and frozen is not None and not params.frozen_adapt
                and params.qual_nctx() % len(devices) == 0
                and params.qual_nctx() * (frozen["qmax"] + 2)
                >= CTX_SHARD_MIN_ENTRIES):
            ctx_shard, devices = devices, None
        whole_md5 = hashlib.md5()

        def decode_one(i, payload, device):
            return _decode_checked(params, payload, frozen, device,
                                   ref_codes, reader.blocks[i].md5, i,
                                   ctx_shard, dbg)[1]

        with (open(out_name, "wb") if out_name
              else contextlib.nullcontext(sys.stdout.buffer)) as out:
            payloads = _spanned((reader.read_block(i)
                                 for i in range(len(reader.blocks))),
                                dbg, "read")
            with dbg.span("decode"):
                for _, raw in device_parallel(payloads, decode_one, devices,
                                              params.threads, device):
                    with dbg.span("md5"):
                        whole_md5.update(raw)
                    with dbg.span("write"):
                        out.write(raw)
        if reader.input_md5s and whole_md5.digest() != reader.input_md5s[0]:
            raise ValueError("whole-input MD5 mismatch")
        return [out_name] if out_name else []


def _frozen_of(reader: ArcReader, dbg: Optional[DebugInfo] = None):
    if reader.model_blob is None:
        return None
    from fastqueeze_tpu_torch.pipeline.frozen import deserialize_frozen
    with stage(dbg, "deserialize"):
        return deserialize_frozen(reader.model_blob)


def _decode_checked(params: CodecParams, payload: bytes, frozen, device,
                    ref_codes, md5: bytes, i: int, ctx_shard=None,
                    dbg: Optional[DebugInfo] = None):
    """(block, plaintext) of SE block ``i``, its MD5 verified; ctx_shard:
    the devices the frozen qual table is sharded over."""
    block = decode_block(params, payload, frozen, device, ref_codes,
                         ctx_shard, dbg)
    with stage(dbg, "assemble"):
        raw = assemble_block(block)
    with stage(dbg, "md5"):
        ok = hashlib.md5(raw).digest() == md5
    if not ok:
        raise ValueError(f"block {i}: MD5 mismatch (corrupt archive)")
    return block, raw


def extract(arc_path: str, out_prefix: Optional[str], start: int,
            count: int, ref: Optional[str] = None, force: bool = False,
            dbg: Optional[DebugInfo] = None, device="cuda") -> List[str]:
    """Random-access decode (-X): reads [start, start+count) from only
    the blocks that cover them (the block table's read counts locate
    them; each block's MD5 is still verified).  PE archives count pairs
    and write <prefix>_1.fastq and <prefix>_2.fastq."""
    if start < 0 or count <= 0:
        raise ValueError("extract needs start >= 0 and count > 0")
    with ArcReader(arc_path) as reader:
        _reject_partial(reader, arc_path)
        params = reader.params
        if getattr(params, "multi", 0):
            raise ValueError("-X is not supported on multi-file archives")
        ref_codes = _load_ref_for_decode(params, ref)
        frozen = _frozen_of(reader)
        total = sum(b.n_reads for b in reader.blocks)
        if start + count > total:
            raise ValueError(
                f"read range [{start}, {start + count}) exceeds archive "
                f"({total} {'pairs' if params.is_pe else 'reads'})")

        pieces1, pieces2 = [], []
        cum = 0
        for i, info in enumerate(reader.blocks):
            lo, hi = cum, cum + info.n_reads
            cum = hi
            if hi <= start or lo >= start + count:
                continue
            payload = reader.read_block(i)
            s = max(start - lo, 0)
            e = min(start + count - lo, info.n_reads)
            if params.is_pe:
                from fastqueeze_tpu_torch.pipeline.pe import decode_pe_payload
                b1, b2, _, _ = decode_pe_payload(params, payload, frozen,
                                                 ref_codes, info.md5, i,
                                                 device)
                pieces1.append(_slice_records(b1, s, e))
                pieces2.append(_slice_records(b2, s, e))
            else:
                block, _ = _decode_checked(params, payload, frozen, device,
                                           ref_codes, info.md5, i)
                pieces1.append(_slice_records(block, s, e))

        base = out_prefix or (os.path.splitext(arc_path)[0] + "_extract")
        if params.is_pe:
            outs = [base + "_1.fastq", base + "_2.fastq"]
            datas = [b"".join(pieces1), b"".join(pieces2)]
        else:
            outs = [base + ".fastq"]
            datas = [b"".join(pieces1)]
        for name, data in zip(outs, datas):
            if os.path.exists(name) and not force:
                raise ValueError(f"{name} exists (use -f to overwrite)")
            with open(name, "wb") as fh:
                fh.write(data)
        return outs


def _slice_records(block, s: int, e: int) -> bytes:
    """Plaintext of records [s, e) of a decoded block; a slice reaching
    the block's last record keeps its final_newline, so the tail of an
    input without a trailing newline extracts byte-exact."""
    from fastqueeze_tpu_torch.io.fastq import FastqBlock
    offs = np.cumsum(block.lengths) - block.lengths
    a = int(offs[s])
    b = int(offs[e - 1] + block.lengths[e - 1])
    fnl = block.final_newline if e == block.n_reads else True
    sub = FastqBlock(
        n_reads=e - s, ids=list(block.ids[s:e]), plus=list(block.plus[s:e]),
        seq_flat=block.seq_flat[a:b], qual_flat=block.qual_flat[a:b],
        lengths=block.lengths[s:e], raw_len=0, final_newline=fnl)
    return assemble_block(sub)


def compress_multi(params: CodecParams, in_paths: List[str], out_path: str,
                   dbg: Optional[DebugInfo] = None, device="cuda") -> Dict:
    """Multi-file archive (-m): several SE inputs into one archive with
    a file list; the frozen model (when the gate says so) is trained on
    the first file, self-alignment stays off, every block carries its
    input's file_id, and the archive holds one whole-input MD5 a file."""
    from fastqueeze_tpu_torch.pipeline.frozen import decide_use_model
    devices = block_dp_devices(params, device)
    dbg = dbg or DebugInfo()
    params.multi = 1
    if params.self_align == -1:
        params.self_align = 0      # multi-file blocks never self-align
    block_size = params.block_bytes or params.block_size_mb * (1 << 20)
    writer = ArcWriter(out_path, params,
                       [os.path.basename(x) for x in in_paths], [])
    frozen = None
    if decide_use_model(params, sum(os.path.getsize(x) for x in in_paths)):
        frozen, blob = train_frozen_prefix(params, in_paths[0], device, dbg)
        writer.set_model(blob)
    md5s = [hashlib.md5() for _ in in_paths]

    def items():
        for fid, path in enumerate(in_paths):
            for raw, final_nl in read_blocks(path, block_size):
                yield fid, raw, final_nl

    def work(_i, item, device):
        fid, raw, final_nl = item
        raw, block = parse_lossy(params, raw, final_nl)
        payload = encode_block(params, block, frozen, device, dbg)
        return fid, raw, payload, block.n_reads

    n_blocks = total_raw = 0
    for i, (fid, raw, payload, n_reads) in device_parallel(
            items(), work, devices, params.threads, device):
        md5s[fid].update(raw)       # blocks arrive in order, fids monotone
        writer.add_block(i, payload, BlockInfo(
            payload_len=len(payload), n_reads=n_reads, raw_len1=len(raw),
            md5=hashlib.md5(raw).digest(), file_id=fid))
        dbg.add("reads", n_reads)
        total_raw += len(raw)
        n_blocks = i + 1
    writer.input_md5s = [m.digest() for m in md5s]
    writer.finalize()
    out_size = os.path.getsize(out_path)
    dbg.add("raw_bytes", total_raw)
    dbg.add("out_bytes", out_size)
    return {"blocks": n_blocks, "raw": total_raw, "compressed": out_size,
            "files": len(in_paths),
            "ratio": total_raw / out_size if out_size else 0.0}


def _decompress_multi(reader: ArcReader, out_prefix: Optional[str],
                      dbg: DebugInfo, frozen, ref_codes, force: bool,
                      device, devices=None) -> List[str]:
    """A multi-file archive back into its files: <prefix>N.fastq, or the
    original names without a prefix; every file's whole-input MD5
    checked."""
    params = reader.params
    names = [f"{out_prefix}{i}.fastq" if out_prefix else orig
             for i, orig in enumerate(reader.file_list)]
    for n in names:
        if os.path.exists(n) and not force:
            raise ValueError(f"{n} exists (use -f to overwrite)")

    def decode_one(i, payload, device):
        return _decode_checked(params, payload, frozen, device, ref_codes,
                               reader.blocks[i].md5, i)[1]

    md5s = [hashlib.md5() for _ in names]
    with dbg.span("decode"), contextlib.ExitStack() as stack:
        outs = [stack.enter_context(open(n, "wb")) for n in names]
        payloads = (reader.read_block(i) for i in range(len(reader.blocks)))
        for i, raw in device_parallel(payloads, decode_one, devices,
                                      params.threads, device):
            fid = reader.blocks[i].file_id
            outs[fid].write(raw)
            md5s[fid].update(raw)
    for i, m in enumerate(md5s):
        if i < len(reader.input_md5s) and m.digest() != reader.input_md5s[i]:
            raise ValueError(f"file {i}: whole-input MD5 mismatch")
    return names


def _load_ref_for_decode(params: CodecParams, ref: Optional[str]):
    """Aligned archives need the reference FASTA at decode (never the
    index); a missing or wrong reference is refused up front."""
    if not getattr(params, "aligned", 0):
        return None
    if not ref:
        raise ValueError("archive was compressed with a reference; decode "
                         "needs the same FASTA (fastqueeze -d ref.fa arc)")
    from fastqueeze_tpu_torch.align.ref import load_fasta
    r = load_fasta(ref)
    if params.ref_md5 and r.md5 != params.ref_md5:
        raise ValueError(f"wrong reference file: md5 {r.md5} != archive's "
                         f"{params.ref_md5}")
    return r.codes


def _se_out_name(arc_path: str, out_prefix: Optional[str],
                 file_list: List[str]) -> str:
    if out_prefix:
        return out_prefix + ".fastq"
    if file_list:
        return file_list[0]
    return arc_path + ".fastq"
