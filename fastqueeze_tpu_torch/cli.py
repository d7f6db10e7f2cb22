"""Command-line interface of the port:

    python -m fastqueeze_tpu_torch.cli -i ref.fa [-q]
    python -m fastqueeze_tpu_torch.cli -D
    python -m fastqueeze_tpu_torch.cli -c [ref.fa] -1 in.fq [-2 in_2.fq]
        -o out.fqz [-f] [-t N] [--qlevel N] [--slevel N] [--block-mb N]
        [-q] [-s] [-S] [-I N] [-l F] [-p] [--part K:N] [--mesh N]
    python -m fastqueeze_tpu_torch.cli -c -m -1 a.fq -1 b.fq -1 c.fq -o out.fqz
    python -m fastqueeze_tpu_torch.cli -d [ref.fa] out.fqz -o prefix [-f]
        [-t N] [-P 1|2|3] [-p] [-X START:COUNT] [--mesh N]
    python -m fastqueeze_tpu_torch.cli --merge part0.fqz ... -o out.fqz
    python -m fastqueeze_tpu_torch.cli -L out.fqz
    (any of these) [--cpu] [--profile DIR] [--stats]

The flags and archives are those of fastqueeze_tpu's CLI.  The coder and
the aligner run on the CUDA card; with no card the CLI stops with an
error and never continues on the CPU unless ``--cpu`` asks for the CPU:
then the kernels' plain PyTorch versions and the native host coders run,
as ``api`` does with ``device="cpu"``, and write the same archive.
(``-i`` builds the index on the host, ``--merge`` and ``-L`` only read
archives, and ``-D`` writes the developer config file ./fastqueeze.config
with the defaults, which every compress reads, e.g. ``AdaptChunk:64``
for the semi-adaptive walk; none of them needs a card.)  ``--profile
DIR`` traces the whole run with torch.profiler (the host's activity, and
the card's kernels and copies when the run is on the card; the command
is the span named ``fastqueeze_cli``, each stage of it a range
``fq.<stage>``, as ``--stats`` names them) and writes the trace, also when
the run fails, to DIR/fastqueeze.pt.trace.json, a Chrome trace
(chrome://tracing, Perfetto or TensorBoard's profiler); it changes no
archive byte, and a profiler that cannot start stops the run.
``--part K:N`` writes the partial archive of blocks K, K+N, ... (0 <= K
< N <= 2^32-1), ``--merge`` assembles the N parts into the single-run
archive, ``-X`` decodes only the covering
blocks, ``-m`` puts several inputs into one archive.  ``--mesh N``
runs the blocks data-parallel over N cards (-1 = all; more than are
visible is refused; one card: a no-op written into PARAM); the archive
is byte-identical to a single-card run, and on decode 0 or unset takes
the encoder's setting, clamped to the visible cards.  ``-n`` is
accepted and ignored, as in the reference.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.utils.log import error, info
from fastqueeze_tpu_torch.utils.metrics import DebugInfo


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fastqueeze",
        description="FASTQ compressor on PyTorch + CUDA (port of "
                    "fastqueeze_tpu; same archives)")
    ap.add_argument("-i", "--index", metavar="REF",
                    help="build the index file of REF (REF.fqzidx)")
    ap.add_argument("-c", "--compress", action="store_true")
    ap.add_argument("-d", "--decompress", action="store_true")
    ap.add_argument("pos", nargs="*", default=[],
                    help="[ref.fa] for -c; [ref.fa] archive for -d; the "
                    "parts for --merge")
    ap.add_argument("-1", dest="in1", action="append",
                    help="input FASTQ (SE or PE1); repeat with -m")
    ap.add_argument("-2", dest="in2", help="input FASTQ (PE2)")
    ap.add_argument("-m", dest="multi", action="store_true",
                    help="multi-file archive: pass several -1 inputs")
    ap.add_argument("-L", "--list", dest="list_arc", metavar="ARCHIVE",
                    help="list archive contents (files, blocks, params)")
    ap.add_argument("-o", dest="out", help="output archive / prefix")
    ap.add_argument("-f", dest="force", action="store_true",
                    help="force overwrite")
    ap.add_argument("-t", dest="threads", type=int, default=None,
                    help="host worker threads (blocks in flight)")
    ap.add_argument("-l", dest="lossy", type=float, default=None,
                    help="lossy quality factor (e.g. 1.15)")
    ap.add_argument("-I", dest="max_insr", type=int, default=None,
                    help="max insert size for PE alignment")
    ap.add_argument("-s", dest="shm", action="store_true",
                    help="share the index file across processes (mmap)")
    ap.add_argument("-n", dest="no_orderbin", action="store_true",
                    help="accepted for the reference's command lines; reads "
                    "are never reordered, so it changes nothing")
    ap.add_argument("-q", dest="bwa", action="store_true",
                    help="long-seed aligner (22-mers) with the indel tier")
    ap.add_argument("-S", dest="self_align", action="store_true",
                    help="self-referential alignment: code each block's "
                    "reads against its own unmapped reads")
    ap.add_argument("-X", dest="extract", metavar="START:COUNT",
                    help="random-access decode: only reads (PE: pairs) "
                    "[START, START+COUNT), from the covering blocks")
    ap.add_argument("-P", dest="pipeout", type=int, default=0,
                    choices=[0, 1, 2, 3], help="pipe decompressed reads to "
                    "stdout: 1=SE/PE1 2=PE2 3=interleaved")
    ap.add_argument("-p", dest="indir", action="store_true",
                    help="write the output next to the input")
    ap.add_argument("-D", dest="dump_config", action="store_true",
                    help="write ./fastqueeze.config with current defaults")
    ap.add_argument("--block-mb", type=int, default=None,
                    help="block size in MB (default 50)")
    ap.add_argument("--slevel", type=int, default=None,
                    help="sequence context level (default 3)")
    ap.add_argument("--part", metavar="K:N",
                    help="multi-host compress: own blocks K, K+N, ... of the "
                    "input and write a partial archive (--merge the N "
                    "parts into the single-run archive)")
    ap.add_argument("--merge", action="store_true",
                    help="assemble partial archives (--part) into one: "
                    "--merge part*.fqz -o out.fqz")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="block-data-parallel over N cards (-1 = all).  "
                    "Archives are byte-identical to one card's; on decode, "
                    "0/unset inherits the encoder's setting (clamped to "
                    "visible cards)")
    ap.add_argument("--qlevel", type=int, default=None,
                    help="quality context level (default 2; 3 codes "
                    "adaptively with position contexts)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU: the kernels' plain PyTorch "
                    "versions and the native host coders (same archives; "
                    "for validation runs or a machine with no card)")
    ap.add_argument("--stats", action="store_true", help="print debug tables")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace of the run to "
                    "DIR/fastqueeze.pt.trace.json (Chrome trace: "
                    "chrome://tracing, Perfetto, TensorBoard)")
    return ap


def _list_archive(path: str) -> None:
    """An archive's contents: kind, blocks, files, params (the reference
    CLI's -L)."""
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    with ArcReader(path) as r:
        p = r.params
        kind = ("PE" if p.is_pe else
                ("multi" if getattr(p, "multi", 0) else "SE"))
        if r.part is not None:
            kind += f" PARTIAL (part {r.part[0]} of {r.part[1]})"
        print(f"{path}: {kind} archive, {len(r.blocks)} block(s), "
              f"{len(r.file_list)} file(s)")
        print(f"  params: slevel={p.slevel} qlevel={p.qlevel} "
              f"block={p.block_size_mb}MB lossy={p.lossy_factor} "
              f"aligned={p.aligned}"
              + (f" ref_md5={p.ref_md5}" if p.aligned else ""))
        if r.model_blob is not None:
            print(f"  frozen model: {len(r.model_blob):,} B")
        for i, name in enumerate(r.file_list):
            raw = sum((b.raw_len2 if (p.is_pe and i == 1) else b.raw_len1)
                      for b in r.blocks
                      if p.is_pe or b.file_id == i
                      or not getattr(p, "multi", 0))
            print(f"  [{i}] {name}  {raw:,} B plaintext")
        total_payload = sum(b.payload_len for b in r.blocks)
        total_raw = sum(b.raw_len1 + b.raw_len2 for b in r.blocks)
        print(f"  blocks: {total_raw:,} B -> {total_payload:,} B "
              f"({total_raw / max(total_payload, 1):.2f}x)")


def _parse_part(spec: str):
    """--part K:N -> (K, N), None for one part, or an error string."""
    k, _, n = spec.partition(":")
    try:
        part = (int(k), int(n))
    except ValueError:
        return "--part wants K:N (e.g. --part 0:4)"
    if not (0 <= part[0] < part[1] <= 0xFFFFFFFF):
        return f"--part {spec}: need 0 <= K < N <= 2^32-1"
    return part if part[1] > 1 else None   # 1 part == a single-run archive


TRACE_NAME = "fastqueeze.pt.trace.json"
RUN_SPAN = "fastqueeze_cli"     # the trace's span of the whole command


def _start_profile(on_card: bool):
    """A started torch.profiler session: the host's activity, and the
    card's when the run is on it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.time()
    dbg = DebugInfo()
    prof = None
    if args.profile:
        import torch
        try:
            prof = _start_profile(not args.cpu and torch.cuda.is_available())
        except Exception as e:     # any failure to start: the run stops
            error(f"--profile: the profiler did not start: {e}")
            return 2
    try:
        if prof is None:
            rc = _run(args, dbg)
        else:
            from torch.profiler import record_function
            with record_function(RUN_SPAN):
                rc = _run(args, dbg)
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile, TRACE_NAME))
            info(f"profiler trace written to {args.profile}")
    if rc is not None:
        return rc
    if args.stats:
        dbg.print()
    info(f"total time {time.time() - t_start:.2f}s")
    return 0


def _run(args, dbg):
    """The command; an exit code, or None when a compress or decompress
    finished (main then prints --stats and the total time)."""
    if args.dump_config:
        info(f"wrote {CodecParams().dump_config_file()}")
        return 0
    if args.index:
        from fastqueeze_tpu_torch.align.index import build_index
        p = CodecParams()
        p.apply_config_file()
        if args.bwa and p.seed_len <= 15:
            p.seed_len = 22
        try:
            out = build_index(args.index, p)
        except (ValueError, FileNotFoundError) as e:
            error(str(e))
            return 1
        info(f"index written: {out}")
        return 0
    try:
        if args.list_arc:
            _list_archive(args.list_arc)
            return 0
        if args.merge:
            if not args.out or len(args.pos) < 1:
                error("--merge needs part archives + -o out.fqz")
                return 2
            from fastqueeze_tpu_torch.container.arcfile import merge_archives
            stats = merge_archives(args.out, args.pos, force=args.force)
            info(f"merged {stats['parts']} parts -> {args.out} "
                 f"({stats['blocks']} blocks, {stats['compressed']:,} B)")
            return 0
    except (ValueError, FileNotFoundError, EOFError) as e:
        error(str(e))
        return 1
    if not (args.compress or args.decompress):
        build_parser().print_help()
        return 1
    if len(args.pos) > (1 if args.compress else 2):
        error("too many positional arguments")
        return 2
    import torch
    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        error("no CUDA device: this CLI runs its coder on the card and "
              "never falls back to the CPU (--cpu asks for the CPU)")
        return 2
    else:
        device = torch.device("cuda", torch.cuda.current_device())
    from fastqueeze_tpu_torch.pipeline import driver
    from fastqueeze_tpu_torch.pipeline.aligned import compress_se_aligned
    from fastqueeze_tpu_torch.pipeline.pe import compress_pe
    try:
        if args.compress:
            if not args.in1:
                error("compress needs -1 <input.fq>")
                return 2
            in1 = args.in1[0]
            out = args.out or os.path.splitext(in1)[0]
            if not out.endswith(".fqz"):
                out += ".fqz"
            if args.indir:
                out = os.path.join(os.path.dirname(os.path.abspath(in1)),
                                   os.path.basename(out))
            if os.path.exists(out) and not args.force:
                error(f"{out} exists (use -f to overwrite)")
                return 2
            ref = args.pos[0] if args.pos else None
            p = CodecParams(is_pe=1 if args.in2 else 0)
            p.apply_config_file()      # developer config (seqarc.config)
            for attr, val in (("block_size_mb", args.block_mb),
                              ("slevel", args.slevel),
                              ("qlevel", args.qlevel),
                              ("lossy_factor", args.lossy),
                              ("max_insr", args.max_insr),
                              ("threads", args.threads),
                              ("mesh_n", args.mesh)):
                if val is not None:    # explicit CLI flag beats config file
                    setattr(p, attr, val)
            if args.bwa:
                if p.seed_len <= 15:
                    p.seed_len = 22    # -q: long-seed aligner
                if p.max_indel == 0:
                    p.max_indel = 3    # -q: with the indel tier
            part = None
            if args.part:
                part = _parse_part(args.part)
                if isinstance(part, str):
                    error(part)
                    return 2
            if args.shm:
                p.shm_index = 1
            if args.self_align:
                if ref or args.multi:
                    error("-S is reference-free (no ref.fa / -m)")
                    return 2
                p.self_align = 1
            if args.multi:
                if args.in2 or ref:
                    error("-m supports plain SE inputs (no -2 / reference)")
                    return 2
                if part:
                    error("--part is not supported with -m")
                    return 2
                stats = driver.compress_multi(p, args.in1, out, dbg=dbg,
                                              device=device)
            elif args.in2:
                stats = compress_pe(p, in1, args.in2, out, ref=ref, dbg=dbg,
                                    part=part, device=device)
            elif ref:
                stats = compress_se_aligned(p, ref, in1, out, dbg=dbg,
                                            part=part, device=device)
            else:
                stats = driver.compress_se(p, in1, out, dbg=dbg, part=part,
                                           device=device)
            if ref:
                info(f"mapped {stats['mapped']:,} of {stats['reads']:,} "
                     f"reads")
            info(f"compressed {stats['raw']:,} -> {stats['compressed']:,} B "
                 f"(ratio {stats['ratio']:.2f}x) in {stats['blocks']} blocks")
        else:
            if args.part:
                error("--part applies to compression only")
                return 2
            if not args.pos:
                error("decompress needs an archive path")
                return 2
            ref = args.pos[0] if len(args.pos) == 2 else None
            if args.extract:
                s, _, c = args.extract.partition(":")
                outs = driver.extract(args.pos[-1], args.out, int(s),
                                      int(c or 1), ref=ref,
                                      force=args.force, dbg=dbg,
                                      device=device)
            else:
                outs = driver.decompress(
                    args.pos[-1], args.out, dbg=dbg, force=args.force,
                    threads=args.threads or 0, device=device, ref=ref,
                    pipeout=args.pipeout, indir=args.indir,
                    mesh=args.mesh or 0)
            if outs:
                info("wrote: " + ", ".join(outs))
    except NotImplementedError as e:
        error(f"not ported yet: {e}")
        return 2
    except (ValueError, FileNotFoundError, EOFError) as e:
        error(str(e))
        return 1
    return None


if __name__ == "__main__":
    sys.exit(main())
