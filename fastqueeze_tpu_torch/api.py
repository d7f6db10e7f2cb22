"""One-call library API of the port.

The CLI (`python -m fastqueeze_tpu_torch.cli`) mirrors the reference
binary; this module is the entry point for programmatic use, with the
calls and archives of fastqueeze_tpu's api:

    from fastqueeze_tpu_torch import api

    stats = api.compress("reads.fq", "out.fqz")                 # SE
    stats = api.compress(("r1.fq", "r2.fq"), "out.fqz")         # PE
    stats = api.compress("reads.fq", "out.fqz", reference="ref.fa")
    paths = api.decompress("out.fqz", "restored")               # bit-exact
    info  = api.describe("out.fqz")
    stats = api.compress(["a.fq", "b.fq", "c.fq"], "multi.fqz")  # -m
    stats = api.compress("reads.fq", "p0.fqz", part=(0, 2))      # --part
    stats = api.merge("out.fqz", ["p0.fqz", "p1.fqz"])          # --merge
    paths = api.extract("out.fqz", 1000, 50, "slice")           # -X
    dbg = DebugInfo()                       # utils/metrics.py
    stats = api.compress("reads.fq", "out.fqz", dbg=dbg)
    dbg.print()                             # the table --stats prints

Parameters are the `CodecParams` the CLI builds from its flags; only here
can a caller set the ones no flag sets, such as ``frozen_adapt`` (keep
adapting from the trained tables).  The coder and the aligner run on
``device``, the CUDA card by default; ``device="cpu"`` runs the kernels'
plain PyTorch versions and the native host coders.  ``lossy`` (-l) sets
lossy_factor; ``mesh`` runs the blocks data-parallel over that many
visible devices (-1 = all), writing the single-device archive byte for
byte.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.utils.metrics import DebugInfo

Inputs = Union[str, Sequence[str]]


def _params(params: Optional[CodecParams], **overrides) -> CodecParams:
    p = params if params is not None else CodecParams()
    for k, v in overrides.items():
        if v is not None:
            setattr(p, k, v)
    return p


def compress(inputs: Inputs, out_path: str, *,
             reference: Optional[str] = None,
             params: Optional[CodecParams] = None,
             threads: Optional[int] = None,
             lossy: Optional[float] = None,
             mesh: Optional[int] = None,
             self_ref: Optional[bool] = None,
             part: Optional[tuple] = None,
             device="cuda", dbg: Optional[DebugInfo] = None) -> Dict:
    """Compress FASTQ file(s) into a .fqz archive.

    inputs: one path (SE), a (r1, r2) pair (PE), or 3+ paths (a
    multi-file archive, the CLI's `-m`).  reference: FASTA path to align
    against (the index file is loaded or built).  self_ref:
    self-referential alignment (the CLI's `-S`; not with `reference`).
    lossy: the R-Block quality factor (the CLI's `-l`; above 1.0 the
    qualities are transformed).  mesh: block data-parallelism over N
    devices, -1 = all (the CLI's `--mesh`).  part: (k, n), this call owns
    blocks k, k+n, ... and writes a partial archive (the CLI's `--part
    K:N`; assemble with :func:`merge`).  dbg: a DebugInfo that receives
    the stage table the CLI's `--stats` prints (each stage's seconds and
    count, stream sizes).  Returns the driver's stats dict (raw/compressed
    bytes, ratio, blocks, ...)."""
    if part is not None:
        if not (0 <= part[0] < part[1] <= 0xFFFFFFFF):
            raise ValueError(
                f"part wants (k, n) with 0 <= k < n, got {part}")
        if part[1] == 1:
            part = None            # 1 part == a plain single-run archive
    p = _params(params, threads=threads, mesh_n=mesh)
    if lossy is not None:
        p.lossy_factor = lossy
    if self_ref:
        if reference is not None:
            raise ValueError("self_ref and reference are mutually "
                             "exclusive")
        p.self_align = 1
    paths = [inputs] if isinstance(inputs, str) else list(inputs)
    if reference is not None:
        from fastqueeze_tpu_torch.pipeline.aligned import (
            compress_pe_aligned, compress_se_aligned)
        if len(paths) == 1:
            return compress_se_aligned(p, reference, paths[0], out_path,
                                       dbg=dbg, part=part, device=device)
        if len(paths) == 2:
            return compress_pe_aligned(p, reference, paths[0], paths[1],
                                       out_path, dbg=dbg, part=part,
                                       device=device)
        raise ValueError("aligned mode takes 1 (SE) or 2 (PE) inputs")
    if len(paths) == 1:
        from fastqueeze_tpu_torch.pipeline.driver import compress_se
        return compress_se(p, paths[0], out_path, dbg=dbg, part=part,
                           device=device)
    if len(paths) == 2:
        from fastqueeze_tpu_torch.pipeline.pe import compress_pe
        return compress_pe(p, paths[0], paths[1], out_path, dbg=dbg,
                           part=part, device=device)
    if part is not None:
        raise ValueError("part is not supported with multi-file archives")
    from fastqueeze_tpu_torch.pipeline.driver import compress_multi
    return compress_multi(p, paths, out_path, dbg=dbg, device=device)


def merge(out_path: str, parts: Sequence[str], *,
          force: bool = True) -> Dict:
    """Assemble partial archives (compress(part=(k, n))) into the final
    archive, byte-identical to a single-run archive (the CLI's
    `--merge`)."""
    from fastqueeze_tpu_torch.container.arcfile import merge_archives
    return merge_archives(out_path, list(parts), force=force)


def decompress(archive: str, out_prefix: str, *,
               reference: Optional[str] = None,
               force: bool = True,
               threads: Optional[int] = None,
               device="cuda", dbg: Optional[DebugInfo] = None) -> List[str]:
    """Restore the original FASTQ file(s) from an archive (bit-exact;
    verified against the stored MD5s).  Returns the written paths.
    Aligned archives need the same reference FASTA (checked by MD5).
    dbg: a DebugInfo that receives the stage table, as in compress."""
    from fastqueeze_tpu_torch.pipeline.driver import decompress as _d
    return _d(archive, out_prefix, dbg=dbg, force=force,
              threads=threads or 0, device=device, ref=reference)


def extract(archive: str, start: int, count: int, out_prefix: str, *,
            reference: Optional[str] = None, force: bool = True,
            device="cuda") -> List[str]:
    """Random-access extraction: decode only the blocks covering reads
    (SE) or pairs (PE) [start, start+count) (the CLI's `-X`)."""
    from fastqueeze_tpu_torch.pipeline.driver import extract as _x
    return _x(archive, out_prefix, start, count, ref=reference,
              force=force, device=device)


def describe(archive: str) -> Dict:
    """Archive metadata: files, params, blocks, sizes (the CLI's -L)."""
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    with ArcReader(archive) as r:
        p = r.params
        return {
            "kind": ("PE" if p.is_pe else
                     ("multi" if getattr(p, "multi", 0) else "SE")),
            "files": list(r.file_list),
            "blocks": len(r.blocks),
            "aligned": bool(p.aligned),
            "params": p,
            "model_bytes": len(r.model_blob) if r.model_blob else 0,
            "raw_bytes": sum(b.raw_len1 + b.raw_len2 for b in r.blocks),
            "payload_bytes": sum(b.payload_len for b in r.blocks),
            "archive_bytes": os.path.getsize(archive),
        }


def build_index(reference: str,
                params: Optional[CodecParams] = None) -> str:
    """Build (or refresh) the seed index file of a reference FASTA;
    returns its path.  compress(reference=...) loads or builds it."""
    from fastqueeze_tpu_torch.align.index import build_index as _b
    return _b(reference, _params(params))
