"""Command-line interface of the port:

    python -m fastqueeze_tpu_torch.cli -i ref.fa [-q]
    python -m fastqueeze_tpu_torch.cli -D
    python -m fastqueeze_tpu_torch.cli -c [ref.fa] -1 in.fq [-2 in_2.fq]
        -o out.fqz [-f] [-t N] [--qlevel N] [-q] [-s] [-S] [-I N] [-l F]
        [--mesh N]
    python -m fastqueeze_tpu_torch.cli -d [ref.fa] out.fqz -o prefix [-f]
        [-t N] [-P 1|2|3] [--mesh N]

The flags and archives are those of fastqueeze_tpu's CLI.  The coder and
the aligner run on the CUDA card; with no card the CLI stops with an
error and never continues on the CPU (``-i`` builds the index on the
host and needs no card; ``-D`` writes the developer config file
./fastqueeze.config with the defaults, which every compress reads, e.g.
``AdaptChunk:64`` for the semi-adaptive walk).  ``--mesh N`` resolves
against the visible cards (-1 = all; more than are visible is refused);
on one card it is a no-op written into PARAM.  Flags of modes the port
lacks (-m, -X, --part, --mesh over 2 or more cards) exit with the ROADMAP
item that ports them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.utils.log import error, info
from fastqueeze_tpu_torch.utils.metrics import DebugInfo

_UNPORTED = (
    ("multi", "multi-file archives (-m): ROADMAP Queue A item 4"),
    ("extract", "random-access decode (-X): ROADMAP Queue A item 4"),
    ("part", "multi-host parts (--part): ROADMAP Queue A item 4"),
)


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
                    help="[ref.fa] for -c; [ref.fa] archive for -d")
    ap.add_argument("-1", dest="in1", action="append", help="input FASTQ")
    ap.add_argument("-2", dest="in2", help="input FASTQ (PE2)")
    ap.add_argument("-m", dest="multi", action="store_true",
                    help="multi-file archive (not ported)")
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
    ap.add_argument("-q", dest="bwa", action="store_true",
                    help="long-seed aligner (22-mers) with the indel tier")
    ap.add_argument("-S", dest="self_align", action="store_true",
                    help="self-referential alignment: code each block's "
                    "reads against its own unmapped reads")
    ap.add_argument("-X", dest="extract", metavar="START:COUNT",
                    help="random-access decode (not ported)")
    ap.add_argument("-P", dest="pipeout", type=int, default=0,
                    choices=[0, 1, 2, 3], help="pipe decompressed reads to "
                    "stdout: 1=SE/PE1 2=PE2 3=interleaved")
    ap.add_argument("-D", dest="dump_config", action="store_true",
                    help="write ./fastqueeze.config with current defaults")
    ap.add_argument("--part", metavar="K:N",
                    help="multi-host compress (not ported)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="block data-parallelism over N cards (-1 = all; "
                    "one card: a no-op; 2 or more: not ported)")
    ap.add_argument("--qlevel", type=int, default=None,
                    help="quality context level (default 2; 3 codes "
                    "adaptively with position contexts)")
    ap.add_argument("--stats", action="store_true", help="print debug tables")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.time()
    dbg = DebugInfo()
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
    if not (args.compress or args.decompress):
        build_parser().print_help()
        return 1
    for attr, why in _UNPORTED:
        if getattr(args, attr):
            error(f"not ported yet: {why}")
            return 2
    if len(args.pos) > (1 if args.compress else 2):
        error("too many positional arguments")
        return 2
    import torch
    if not torch.cuda.is_available():
        error("no CUDA device: this CLI runs its coder on the card and "
              "never falls back to the CPU")
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    from fastqueeze_tpu_torch.pipeline.aligned import compress_se_aligned
    from fastqueeze_tpu_torch.pipeline.driver import compress_se, decompress
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
            if os.path.exists(out) and not args.force:
                error(f"{out} exists (use -f to overwrite)")
                return 2
            p = CodecParams(is_pe=1 if args.in2 else 0)
            p.apply_config_file()      # developer config (seqarc.config)
            for attr, val in (("qlevel", args.qlevel),
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
            if args.shm:
                p.shm_index = 1
            ref = args.pos[0] if args.pos else None
            if args.self_align:
                if ref:
                    error("-S is reference-free (no ref.fa)")
                    return 2
                p.self_align = 1
            if args.in2:
                stats = compress_pe(p, in1, args.in2, out, ref=ref, dbg=dbg,
                                    device=device)
            elif ref:
                stats = compress_se_aligned(p, ref, in1, out, dbg=dbg,
                                            device=device)
            else:
                stats = compress_se(p, in1, out, dbg=dbg, device=device)
            if ref:
                info(f"mapped {stats['mapped']:,} of {stats['reads']:,} "
                     f"reads")
            info(f"compressed {stats['raw']:,} -> {stats['compressed']:,} B "
                 f"(ratio {stats['ratio']:.2f}x) in {stats['blocks']} blocks")
        else:
            if not args.pos:
                error("decompress needs an archive path")
                return 2
            ref = args.pos[0] if len(args.pos) == 2 else None
            outs = decompress(args.pos[-1], args.out, dbg=dbg,
                              force=args.force, threads=args.threads or 0,
                              device=device, ref=ref, pipeout=args.pipeout,
                              mesh=args.mesh or 0)
            if outs:
                info("wrote: " + ", ".join(outs))
    except NotImplementedError as e:
        error(f"not ported yet: {e}")
        return 2
    except (ValueError, FileNotFoundError, EOFError) as e:
        error(str(e))
        return 1
    if args.stats:
        dbg.print()
    info(f"total time {time.time() - t_start:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
