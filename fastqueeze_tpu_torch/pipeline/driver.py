"""File-level compress/decompress orchestration.

Copied from fastqueeze_tpu/pipeline/driver.py (compress_se, decompress):
cut the input into blocks, train the frozen tables on a prefix when the
usemodel gate says so (else every block codes adaptively and the archive
has no model), encode each block, record per-block MD5 + whole-input
MD5, write the container; on decode, verify both and reassemble the
plaintext.  Every stage takes the engine's ``device`` explicitly.

Self-referential blocks (auto probe or -S) are coded here; compressing
against a reference FASTA is pipeline/aligned.py, paired-end input is
pipeline/pe.py, and decompress takes the FASTA (``ref``) and sends PE
archives to pe.decompress_pe_blocks.  With lossy_factor > 1 (-l) every
block's qualities take the R-Block transform before its MD5 (and the
training prefix before training).  --mesh resolves against the visible
devices; block data-parallelism over 2 or more is not ported (ROADMAP
Queue A item 9), nor are --part, -X and -m (item 4), each raising
NotImplementedError with its item.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import sys
import time
from typing import Dict, List, Optional

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import (
    ArcReader, ArcWriter, BlockInfo)
from fastqueeze_tpu_torch.io.fastq import assemble_block, read_blocks
from fastqueeze_tpu_torch.pipeline.blockcodec import (
    decode_block, encode_block_job)
from fastqueeze_tpu_torch.pipeline.lossy import parse_lossy
from fastqueeze_tpu_torch.pipeline.parallel_host import (
    block_devices, ordered_parallel)
from fastqueeze_tpu_torch.utils.metrics import DebugInfo


def _gate_bytes(in_path: str) -> int:
    """usemodel gate input-size estimate; gz inputs scale x5 (the
    reference's heuristic, doCheckSetEncodeOpt @0x408298)."""
    sz = os.path.getsize(in_path)
    return sz * 5 if in_path.endswith(".gz") else sz


def _train(params: CodecParams, in_path: str, gen, prefix_items: List,
           device, dbg: DebugInfo) -> Dict:
    """usemodel preprocess (reference doPreProcess): pull blocks from
    ``gen`` until the training prefix is covered, parse them once into
    ``prefix_items`` (the encode loop reuses them), train the frozen
    tables from the parsed arrays and upload them to ``device``."""
    from fastqueeze_tpu_torch.pipeline.blockcodec import dedup_training_block
    from fastqueeze_tpu_torch.pipeline.frozen import (
        stage_tables, train_frozen_blocks)
    t0 = time.time()
    need = params.model_train_mb << 20
    got = 0
    for raw, final_nl in gen:
        raw, block = parse_lossy(params, raw, final_nl)
        prefix_items.append((raw, final_nl, block))
        got += len(raw)
        if got >= need:
            break
    syms = sum(int(b.lengths.sum()) for _, _, b in prefix_items)
    est = int(_gate_bytes(in_path) * syms / max(got, 1))
    tblocks = [b for _, _, b in prefix_items]
    if params.dedup:
        # train on the deduped sample (what the coder will emit) so the
        # qctx cost model prices tables honestly
        tblocks = [dedup_training_block(b, params)[0] for b in tblocks]
        uq = sum(int(tb.lengths.sum()) for tb in tblocks)
        est = int(est * uq / max(syms, 1))
    frozen = train_frozen_blocks(params, tblocks, est_total_syms=est)
    stage_tables(frozen, params, device)
    dbg.add("train_s", time.time() - t0)
    return frozen


def compress_se(params: CodecParams, in_path: str, out_path: str,
                dbg: Optional[DebugInfo] = None, device="cuda") -> Dict:
    block_devices(params.mesh_n, device)
    from fastqueeze_tpu_torch.pipeline.frozen import decide_use_model
    dbg = dbg or DebugInfo()
    block_size = params.block_bytes or params.block_size_mb * (1 << 20)
    whole_md5 = hashlib.md5()
    gen = read_blocks(in_path, block_size)
    frozen = None
    prefix_items = []   # (raw, final_nl, FastqBlock): parsed once, reused
    if decide_use_model(params, _gate_bytes(in_path)):
        frozen = _train(params, in_path, gen, prefix_items, device, dbg)

    if params.self_align == -1:
        # auto (-S default): decided once per file from the first block;
        # the answer is written into PARAM
        from fastqueeze_tpu_torch.pipeline.selfref import auto_self_align
        if not prefix_items:
            first = next(gen, None)
            if first is not None:
                raw0, blk0 = parse_lossy(params, *first)
                prefix_items.append((raw0, first[1], blk0))
        params.self_align = 1 if (
            prefix_items
            and auto_self_align(params, prefix_items[0][2], dbg)) else 0
    model_blob = None
    if frozen is not None:
        from fastqueeze_tpu_torch.pipeline.frozen import serialize_frozen
        model_blob = serialize_frozen(frozen)
    writer = ArcWriter(out_path, params, [os.path.basename(in_path)], [],
                       model_blob=model_blob)

    def items():
        yield from prefix_items
        for raw, final_nl in gen:
            yield raw, final_nl, None

    def encode_job(block):
        align = ref_codes = None
        if params.self_align:
            from fastqueeze_tpu_torch.pipeline.selfref import maybe_align_self
            align, ref_codes = maybe_align_self(params, block, dbg)
        return encode_block_job(params, block, frozen, device, dbg, align,
                                ref_codes, self_ref=align is not None)

    n_blocks = total_raw = 0
    if params.threads > 1:
        def work(_i, item):
            raw, final_nl, block = item
            if block is None:
                raw, block = parse_lossy(params, raw, final_nl)
            return raw, encode_job(block)(), block.n_reads

        t_all = time.time()
        for i, (raw, payload, n_reads) in ordered_parallel(
                items(), work, params.threads):
            whole_md5.update(raw)
            writer.add_block(i, payload, BlockInfo(
                payload_len=len(payload), n_reads=n_reads,
                raw_len1=len(raw), md5=hashlib.md5(raw).digest()))
            dbg.add("reads", n_reads)
            total_raw += len(raw)
            n_blocks += 1
        dbg.add("encode_s", time.time() - t_all)
    else:
        pending = None      # (idx, finalize, BlockInfo): device in flight

        def flush(pend):
            t0 = time.time()
            payload = pend[1]()
            dbg.add("encode_s", time.time() - t0)
            writer.add_block(pend[0], payload, pend[2])

        for i, (raw, final_nl, block) in enumerate(items()):
            t0 = time.time()
            if block is None:
                raw, block = parse_lossy(params, raw, final_nl)
            whole_md5.update(raw)
            dbg.add("parse_s", time.time() - t0)
            t0 = time.time()
            fin = encode_job(block)
            dbg.add("dispatch_s", time.time() - t0)
            info = BlockInfo(payload_len=0, n_reads=block.n_reads,
                             raw_len1=len(raw),
                             md5=hashlib.md5(raw).digest())
            if pending is not None:
                flush(pending)
            pending = (i, fin, info)
            dbg.add("reads", block.n_reads)
            total_raw += len(raw)
            n_blocks += 1
        if pending is not None:
            flush(pending)
    writer.input_md5s = [whole_md5.digest()]
    writer.finalize()
    out_size = os.path.getsize(out_path)
    dbg.add("raw_bytes", total_raw)
    dbg.add("out_bytes", out_size)
    return {"blocks": n_blocks, "raw": total_raw, "compressed": out_size,
            "ratio": total_raw / out_size if out_size else 0.0}


def decompress(arc_path: str, out_prefix: Optional[str],
               dbg: Optional[DebugInfo] = None, force: bool = False,
               threads: int = 0, device="cuda", ref: Optional[str] = None,
               pipeout: int = 0, mesh: int = 0) -> List[str]:
    """ref: the reference FASTA of a reference-aligned archive.  pipeout
    (-P): write the reads to stdout instead of files; PE archives take 1
    (file 1), 2 (file 2) or 3 (pairs interleaved).  mesh (--mesh)
    overrides the encoder's mesh_n; either is clamped to the visible
    devices."""
    dbg = dbg or DebugInfo()
    with ArcReader(arc_path) as reader:
        if reader.part is not None:
            raise NotImplementedError(
                "partial archives (--part): ROADMAP Queue A item 4")
        params = reader.params
        if threads:            # decode-side -t overrides the encoder's
            params.threads = threads
        if mesh:
            params.mesh_n = mesh
        block_devices(params.mesh_n, device, clamp=True)
        if getattr(params, "multi", 0):
            raise NotImplementedError(
                "multi-file archives (-m): ROADMAP Queue A item 4")
        ref_codes = _load_ref_for_decode(params, ref)
        if params.is_pe:
            from fastqueeze_tpu_torch.pipeline.pe import decompress_pe_blocks
            return decompress_pe_blocks(reader, out_prefix, dbg, device,
                                        pipeout=pipeout, force=force,
                                        ref_codes=ref_codes)
        out_name = _se_out_name(arc_path, out_prefix, reader.file_list)
        if pipeout:
            out_name = None
        elif os.path.exists(out_name) and not force:
            raise ValueError(f"{out_name} exists (use -f to overwrite)")
        frozen = None
        if reader.model_blob is not None:
            from fastqueeze_tpu_torch.pipeline.frozen import deserialize_frozen
            frozen = deserialize_frozen(reader.model_blob)
        whole_md5 = hashlib.md5()

        def decode_one(i, payload):
            block = decode_block(params, payload, frozen, device, ref_codes)
            raw = assemble_block(block)
            if hashlib.md5(raw).digest() != reader.blocks[i].md5:
                raise ValueError(
                    f"block {i}: MD5 mismatch (corrupt archive)")
            return raw

        with (open(out_name, "wb") if out_name
              else contextlib.nullcontext(sys.stdout.buffer)) as out:
            payloads = (reader.read_block(i)
                        for i in range(len(reader.blocks)))
            t0 = time.time()
            for _, raw in ordered_parallel(payloads, decode_one,
                                           params.threads):
                whole_md5.update(raw)
                out.write(raw)
            dbg.add("decode_s", time.time() - t0)
        if reader.input_md5s and whole_md5.digest() != reader.input_md5s[0]:
            raise ValueError("whole-input MD5 mismatch")
        return [out_name] if out_name else []


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
