"""File-level compress/decompress orchestration (single-end, no reference).

Copied from fastqueeze_tpu/pipeline/driver.py (compress_se, decompress):
cut the input into blocks, train the frozen tables on a prefix, encode
each block, record per-block MD5 + whole-input MD5, write the container;
on decode, verify both and reassemble the plaintext.  Every stage takes
the engine's ``device`` explicitly.

Not ported yet, each raising NotImplementedError with its ROADMAP item:
inputs below the usemodel gate and frozen_adapt (Queue A item 5),
self-referential blocks (item 4), --mesh (item 9), --part, -X, -m
(item 4), paired-end (item 6) and references (item 8).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, Optional

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import (
    ArcReader, ArcWriter, BlockInfo)
from fastqueeze_tpu_torch.io.fastq import assemble_block, parse_block, read_blocks
from fastqueeze_tpu_torch.pipeline.blockcodec import (
    decode_block, encode_block, encode_block_job)
from fastqueeze_tpu_torch.pipeline.parallel_host import ordered_parallel
from fastqueeze_tpu_torch.utils.metrics import DebugInfo


def _gate_bytes(in_path: str) -> int:
    """usemodel gate input-size estimate; gz inputs scale x5 (the
    reference's heuristic, doCheckSetEncodeOpt @0x408298)."""
    sz = os.path.getsize(in_path)
    return sz * 5 if in_path.endswith(".gz") else sz


def _unported(params: CodecParams, in_bytes: int) -> Optional[str]:
    """The ROADMAP item of a requested feature the port lacks, or None."""
    from fastqueeze_tpu_torch.pipeline.frozen import decide_use_model
    if params.mesh_n:
        return "--mesh block data-parallelism: ROADMAP Queue A item 9"
    if params.is_pe:
        return "paired-end: ROADMAP Queue A item 6"
    if params.aligned:
        return "reference-aligned mode: ROADMAP Queue A item 8"
    if params.lossy_factor > 1.0:
        return "lossy quality transform: ROADMAP Queue A item 4"
    if params.self_align == 1:
        return "self-referential alignment (-S): ROADMAP Queue A item 4"
    if params.frozen_adapt or not decide_use_model(params, in_bytes):
        return ("adaptive coder (inputs below the usemodel gate, "
                "frozen_adapt, qlevel 3): ROADMAP Queue A item 5")
    return None


def compress_se(params: CodecParams, in_path: str, out_path: str,
                dbg: Optional[DebugInfo] = None, device="cuda") -> Dict:
    why = _unported(params, _gate_bytes(in_path))
    if why:
        raise NotImplementedError(why)
    from fastqueeze_tpu_torch.pipeline.blockcodec import dedup_training_block
    from fastqueeze_tpu_torch.pipeline.frozen import (
        _qual_alphabet, device_tables, serialize_frozen, train_frozen_blocks)
    dbg = dbg or DebugInfo()
    block_size = params.block_bytes or params.block_size_mb * (1 << 20)
    whole_md5 = hashlib.md5()
    gen = read_blocks(in_path, block_size)

    # usemodel preprocess (reference doPreProcess): pull blocks until the
    # training prefix is covered, parse them once, train from the parsed
    # arrays, then feed the same parsed blocks into the encode pipeline
    t0 = time.time()
    prefix_items = []   # (raw, final_nl, FastqBlock)
    need = params.model_train_mb << 20
    got = 0
    for raw, final_nl in gen:
        prefix_items.append((raw, final_nl, parse_block(raw, final_nl)))
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
    device_tables(frozen, _qual_alphabet(frozen["qmax"]),
                  params.qctx_eff_init(), device)
    dbg.add("train_s", time.time() - t0)

    if params.self_align == -1:
        # auto (-S default): decided once per file from the first block;
        # the answer is written into PARAM
        from fastqueeze_tpu_torch.pipeline.selfref import auto_self_align
        on = bool(prefix_items) and auto_self_align(
            params, prefix_items[0][2], dbg)
        if on:
            raise NotImplementedError(
                "self-referential blocks (the auto probe found coverage "
                "data): ROADMAP Queue A item 4")
        params.self_align = 0
    writer = ArcWriter(out_path, params, [os.path.basename(in_path)], [],
                       model_blob=serialize_frozen(frozen))

    def items():
        yield from prefix_items
        for raw, final_nl in gen:
            yield raw, final_nl, None

    n_blocks = total_raw = 0
    if params.threads > 1:
        def work(_i, item):
            raw, final_nl, block = item
            if block is None:
                block = parse_block(raw, final_nl)
            return raw, encode_block(params, block, frozen, device, dbg), \
                block.n_reads

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
                block = parse_block(raw, final_nl)
            whole_md5.update(raw)
            dbg.add("parse_s", time.time() - t0)
            t0 = time.time()
            fin = encode_block_job(params, block, frozen, device, dbg)
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
               threads: int = 0, device="cuda") -> List[str]:
    dbg = dbg or DebugInfo()
    with ArcReader(arc_path) as reader:
        if reader.part is not None:
            raise NotImplementedError(
                "partial archives (--part): ROADMAP Queue A item 4")
        params = reader.params
        if threads:            # decode-side -t overrides the encoder's
            params.threads = threads
        if params.is_pe:
            raise NotImplementedError("paired-end: ROADMAP Queue A item 6")
        if getattr(params, "multi", 0):
            raise NotImplementedError(
                "multi-file archives (-m): ROADMAP Queue A item 4")
        if getattr(params, "aligned", 0):
            raise NotImplementedError(
                "reference-aligned mode: ROADMAP Queue A item 8")
        out_name = _se_out_name(arc_path, out_prefix, reader.file_list)
        if os.path.exists(out_name) and not force:
            raise ValueError(f"{out_name} exists (use -f to overwrite)")
        frozen = None
        if reader.model_blob is not None:
            from fastqueeze_tpu_torch.pipeline.frozen import deserialize_frozen
            frozen = deserialize_frozen(reader.model_blob)
        whole_md5 = hashlib.md5()

        def decode_one(i, payload):
            block = decode_block(params, payload, frozen, device)
            raw = assemble_block(block)
            if hashlib.md5(raw).digest() != reader.blocks[i].md5:
                raise ValueError(
                    f"block {i}: MD5 mismatch (corrupt archive)")
            return raw

        with open(out_name, "wb") as out:
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
        return [out_name]


def _se_out_name(arc_path: str, out_prefix: Optional[str],
                 file_list: List[str]) -> str:
    if out_prefix:
        return out_prefix + ".fastq"
    if file_list:
        return file_list[0]
    return arc_path + ".fastq"
