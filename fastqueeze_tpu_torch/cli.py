"""Command-line interface of the port (single-end, no reference):

    python -m fastqueeze_tpu_torch.cli -c -1 in.fq -o out.fqz [-f] [-t N]
        [--qlevel N]
    python -m fastqueeze_tpu_torch.cli -d out.fqz -o prefix [-f] [-t N]

The flags and archives are those of fastqueeze_tpu's CLI.  The coder runs
on the CUDA card; with no card the CLI stops with an error and never
continues on the CPU.  Flags of modes the port lacks (-2, -m, -X, -S,
--part, --mesh, a reference) exit with the ROADMAP item that ports them.
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
    ("in2", "paired-end (-2): ROADMAP Queue A item 6"),
    ("multi", "multi-file archives (-m): ROADMAP Queue A item 4"),
    ("extract", "random-access decode (-X): ROADMAP Queue A item 4"),
    ("self_align", "self-referential alignment (-S): ROADMAP Queue A "
                   "item 4"),
    ("part", "multi-host parts (--part): ROADMAP Queue A item 4"),
    ("mesh", "--mesh block data-parallelism: ROADMAP Queue A item 9"),
    ("pos", "reference FASTA (aligned mode): ROADMAP Queue A item 8"),
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fastqueeze",
        description="FASTQ compressor on PyTorch + CUDA (port of "
                    "fastqueeze_tpu; same archives)")
    ap.add_argument("-c", "--compress", action="store_true")
    ap.add_argument("-d", "--decompress", action="store_true")
    ap.add_argument("pos", nargs="*", default=[],
                    help="archive for -d ([ref.fa] is not ported yet)")
    ap.add_argument("-1", dest="in1", action="append", help="input FASTQ")
    ap.add_argument("-2", dest="in2", help="input FASTQ (PE2; not ported)")
    ap.add_argument("-m", dest="multi", action="store_true",
                    help="multi-file archive (not ported)")
    ap.add_argument("-o", dest="out", help="output archive / prefix")
    ap.add_argument("-f", dest="force", action="store_true",
                    help="force overwrite")
    ap.add_argument("-t", dest="threads", type=int, default=None,
                    help="host worker threads (blocks in flight)")
    ap.add_argument("-S", dest="self_align", action="store_true",
                    help="self-referential alignment (not ported)")
    ap.add_argument("-X", dest="extract", metavar="START:COUNT",
                    help="random-access decode (not ported)")
    ap.add_argument("--part", metavar="K:N",
                    help="multi-host compress (not ported)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="block data-parallelism over N devices (not "
                    "ported)")
    ap.add_argument("--qlevel", type=int, default=None,
                    help="quality context level (default 2; 3 codes "
                    "adaptively with position contexts)")
    ap.add_argument("--stats", action="store_true", help="print debug tables")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.time()
    dbg = DebugInfo()
    if not (args.compress or args.decompress):
        build_parser().print_help()
        return 1
    for attr, why in _UNPORTED:
        val = getattr(args, attr)
        if attr == "pos":
            val = len(val) > (0 if args.compress else 1)
        if val:
            error(f"not ported yet: {why}")
            return 2
    import torch
    if not torch.cuda.is_available():
        error("no CUDA device: this CLI runs its coder on the card and "
              "never falls back to the CPU")
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    from fastqueeze_tpu_torch.pipeline.driver import compress_se, decompress
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
            p = CodecParams()
            p.apply_config_file()      # developer config (seqarc.config)
            for attr, val in (("qlevel", args.qlevel),
                              ("threads", args.threads)):
                if val is not None:    # explicit CLI flag beats config file
                    setattr(p, attr, val)
            stats = compress_se(p, in1, out, dbg=dbg, device=device)
            info(f"compressed {stats['raw']:,} -> {stats['compressed']:,} B "
                 f"(ratio {stats['ratio']:.2f}x) in {stats['blocks']} blocks")
        else:
            if len(args.pos) != 1:
                error("decompress needs an archive path")
                return 2
            outs = decompress(args.pos[0], args.out, dbg=dbg,
                              force=args.force, threads=args.threads or 0,
                              device=device)
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
