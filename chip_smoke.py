"""Smoke run of fastqueeze_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card: name and power limit;
  2. build: the twenty CUDA kernels from fastqueeze_tpu_torch/csrc;
  3. kernels: each against its plain PyTorch version on the card at the
     main paths' shapes, bit-equal, with times (CUDA events, warmed):
     frozen K1-K4 at L = 4096 lanes, T = 6144 waves (a 50 MB block of
     100 bp reads) for the order-10 seq table and two qual tables (the
     fqz formula, 2^16 rows x 48; a hashed rank chain k=4, 2^16 hash
     rows, 3 pos bits); adaptive K5 -> K7 -> K3 -> K6 at L = 2048,
     T = 3072 (50,000 x 100 bp reads) for order-10 seq and fqz qualities
     (A = 40) at qlevel 2 and 3, and at L = 1024, T = 3072 for an
     order-1 byte stream of 3,000,000 bytes (one block's Illumina IDs);
     the trainer K13 at the frozen shape for the order-10 seq table (with
     torch.bincount over ctx * A + sym timed as the histogram's library
     call) and the semi-adaptive K11 -> K7 -> K3 -> K12 at the adaptive
     shape with chunk 64 for order-10 seq and fqz qualities (A = 40),
     from a fresh table and from the table K13 trains on the stream;
     the aligner's K8 over the seeded 100 Mbp genome's k = 14 index at
     B = 4096 (tier 1: forward, RC) and B = 512 (the rescue tier), and
     K9 over its k = 22 index at B = 512, G = 3, two ops, and K10 over
     the k = 14 packed reference at B = 4096 mates, C = 1128 (-I 500),
     Lp = 128 (100 bp) and 256 (250 bp), with its device time and the
     frame words these mates need (a bound) beside a full scan's, and
     K14 over the tier-1 failures of one 4096-read batch (padded to a
     power of two): rescue only over the k = 14 index (the
     CLI defaults), both halves (G = 3, two ops) over the k = 22 index,
     each beside K8's rescue and K9 launched separately on the same rows;
     and at the long-read chunk tier's shape, 4096 chunks of phase 14's
     long reads at Lp = 1024 over the k = 14 index: K8's tier 1 (both
     strands), K14 with both halves (G = 3, two ops) over its failures,
     and K8's rescue and K9 on K14's rows, each against its plain version
     (K8, K10: equal on mapped and the mapped reads' outputs; K9: on
     found and the found reads' outputs; K14: on m2 and f and the outputs
     of the slots they select; their times replay a captured CUDA graph
     of the calls, since the warp kernels take less device time than the
     wrapper's host work); each kernel's bound
     (bytes over 3.35 TB/s or integer operations over the 16.7 T/s of
     the ALU, popcounts at a quarter of it) and, for
     K3, the time of torch.masked_select, the one PyTorch call that
     computes the same function; the transfer packs at the frozen shape:
     K15 and K16 on the seq grid (mode 2), K15 on first-order Markov
     qualities (40 values) in modes 6, 15 and 23 and binned to 14 values
     in mode 4 (K16 in 6 and 4), K17 on the Markov and on a uniform
     48-symbol grid (its sidecar overflows), with torch.bincount and
     torch.masked_select timed as the library calls of K17's two parts;
     K15's and K16's device time (torch.profiler) and bound in every
     mode, K15's beside
     torch.cumsum of the flat sentinel mask (its ranks) in modes 15 and
     23; K1 on the seq table as i32 and u8, a qual table as u16 and a
     2^20 x 41 u16 table (phase 17's --qlevel 3 shape; each == K1 on
     int32), each with its device time, bound and torch.cumsum(dim=1)
     (its row scan); and one stream's host<->device copies, packed and
     unpacked; K13's
     halves (train_hist, train_rows) == K13 at the frozen shape, and
     train_hist on Markov qualities beside torch.bincount of its keys;
     the row pass (train_rows in place, and train_rows_sum over 2 and 4
     partials) on the raw histograms of the order-10 seq (2^20 x 4),
     --qlevel 3 (2^20 x 41) and hashed (2^19 x 48) tables, each with
     edge rows planted (zeros, a total at cap, one over, one that needs
     all 24 halvings), == its plain version, timed with no copy in the
     window (CUDA events over fresh copies; device ms by torch.profiler,
     the copy left out) beside its bound; B15's call on (2, 2), (4, 1)
     and (1, 4) meshes of shards sharing the card by device work
     (histogram kernels, fills, copies, the row pass, adds) and idle;
     K4's thread-block cluster (CTAs, threads, lanes a thread, how many
     fit the card) and its time a wave on each table; K2's device time by
     kernel on each table (torch.profiler: the forward chunk walk's
     passes, the reverse rANS pass); K3's (the memset and its one
     kernel) on the seq table's words; the reverse chains' ns a step
     (K7 on the first 1,024 and 2,048 waves of K5's seq grid, K2's
     reverse pass on the first 2,048 and 4,096 of the frozen grid, every
     lane live to the last wave: the slope) beside their chain bound and
     the SASS loop's instructions and stall cycles a step; K11's on each stream and start and
     K17's on each grid (its passes); K12's cluster, time a wave and
     device time by kernel (the chunk boundaries' table passes' share) on
     each stream and start; K6's cluster and
     time a wave on each adaptive stream, beside K5's time and the wave
     groups of its heaviest row (the longest chain of its row walk); K18 at
     the frozen shape on a --qlevel 3 qual table (2^20 rows) with the
     table in D = 2 and 4 row shards sharing the card (route (a), one
     launch a stream, its launch count printed) == K4 on the whole table
     (and every lane back at the encoder's initial state), and the
     several-card route (b), two groups of two shards stepped a wave at a
     time with their partials summed on the card between the steps (its
     us a wave printed) == route (a) and K4; both == the plain version on
     the first 512 waves; K19 at B = 4096, Lp = 128 over the k = 14 index
     in 4 key-range shards == its plain version, beside K8's tier 1, with
     its device ms by phase beside the collectives' kernels; the frozen
     trainer's card scorer as --nll runs it (below): K20 and narrow_rows
     each against its plain version, with times and bounds;
  4. frozen end to end: a seeded ~72 MB FASTQ (300,000 x 100 bp reads
     sampled from a random 100 Mbp genome) through the CLI's compress
     and decompress, compared byte for byte; K1-K4, the transfer
     packs K15-K17 and the card scorer's kernels (K13's halves,
     narrow_rows, K20) must have launched, the trainer must have scored
     its tables on the card (qctx_card_scores, no qctx_host_scores) and
     the native host coder must not have run;
  5. oracle: the same input compressed with FASTQUEEZE_FROZEN_EXEC=host
     (the native coder, bit-identical to the JAX package's device path)
     must give the same archive, and it decodes on the card;
  6. adaptive end to end: 50,000 reads of the same kind (~12.0 MB, under
     the usemodel gate) through the CLI, at defaults and with
     --qlevel 3: byte-exact round trip, K5/K7/K3/K6 and K15-K17
     launched, no native
     coder call, and the archive equals the one written with
     FASTQUEEZE_ADAPT_EXEC=host (the native adaptive coder), which
     decodes on the card;
  7. marker-1 streams on the frozen path: 250,000 reads with Illumina
     IDs (two blocks; the first block's ID payload is ~3 MB, over
     host_stream_max) through the CLI, byte-exact; the first block's ID
     stream must carry marker 1 and K5/K6 must have launched;
  8. reference-aligned SE: the genome written as ref.fa, `-i ref.fa`,
     then 300,000 reads (30% reverse strand, 5% with a deletion) through
     the CLI with ref.fa at defaults (frozen path, 2 blocks; K8) and
     50,000 such reads with -q (adaptive path; K8 and K9): byte-exact,
     no native aligner or coder call, and each archive equals the one
     written with FASTQUEEZE_ALIGN_EXEC=host (the native aligner), which
     decodes on the card; decode without the reference and with a wrong
     one must fail;
  9. self-referential blocks: 300,000 reads over a 500 kbp genome (60x,
     a bacterial resequencing run) through the CLI at defaults: the auto
     probe must turn self-ref on (PARAM self_align = 1, AMAP in a block),
     byte-exact;
 10. paired-end, no reference, CLI defaults: 150,000 pairs of 100 bp
     (~72 MB, frozen path, 2 blocks; mate 2 the reverse complement ending
     200-500 bp after mate 1's start; identical SRA IDs) through
     -c -1 r1 -2 r2 and -d: _1/_2 byte-exact, K1-K4 and the card
     scorer's kernels launched, its tables scored on the card, no native
     coder call, and the archive equals the FASTQUEEZE_FROZEN_EXEC=host
     one, which decodes on the card;
 11. paired-end against phase 8's ref.fa with -I 500: 150,000 such pairs,
     5% of the mate 2s seedless (exactly 7 substitutions, at 7, 21, ...,
     91, and no N): byte-exact, K8 and K10 launched, no native aligner
     call, pe_rescued >= 0.9 x the seedless mates, TAG_APDF in every
     aligned block, and the archive equals the FASTQUEEZE_ALIGN_EXEC=host
     one, which decodes on the card; the pair relations are printed;
 12. semi-adaptive walk through the CLI: in a fresh working directory
     `-D` writes ./fastqueeze.config, AdaptChunk set to 64 in it, then
     phase 6's 50,000-read input: byte-exact, K11/K12 launched for seq
     and qual, no native coder call, PARAM adapt_chunk = 64;
 13. adapting from frozen tables through the library API: api.compress
     with CodecParams(frozen_adapt=1) on 60,000 reads (~14.4 MB, over the
     usemodel gate), then api.decompress: byte-exact, a model in the
     archive, K5/K6 launched and no native coder call; again with
     adapt_chunk=64 (K11/K12); on a cut of 5,000 reads with use_model=1
     the card's archive equals api.compress(..., device="cpu") (the plain
     versions); and the engine's train_counts (K13) on a quality stream
     of 50,000 reads, equal to the host trainer's table, as counts0 of
     encode_stream / decode_stream (K5/K7/K3/K6): byte-exact;
 14. long reads against phase 8's ref.fa: 600 reads of 3,000-20,000 bp
     (0.3% substitutions, 10% with a 1-3 bp indel, 30% reverse strand, 5
     exact duplicates) among 60,000 reads of 100 bp (~26 MB, frozen path)
     through the CLI at defaults (K8, K9: the chunk tier's gap budget)
     and with FASTQUEEZE_FUSED_ALIGN=1 (K8, K14), each with the frozen
     trainer's caches emptied first (K1-K4 in both): byte-exact, no native
     aligner call, both archives equal to the FASTQUEEZE_ALIGN_EXEC=host
     one, which decodes on the card; lr_chunks_mapped printed;
 15. phase 6's input through the CLI with -l 1.15 and with --mesh 1: each
     archive equals the FASTQUEEZE_ADAPT_EXEC=host one, the -l decode
     equals the port's R-Block transform of the input, PARAM holds
     lossy_factor 1.15 and mesh_n 1, and --mesh 2 is refused with the
     device count;
 16. the multi-host and random-access modes through the CLI on 100,000
     reads (~24 MB, frozen, --block-mb 8: 3 blocks): --part 0:3, 1:3 and
     2:3, then --merge, equal to the single-run archive (itself equal to
     the FASTQUEEZE_FROZEN_EXEC=host one); -X slices across the block 0/1
     boundary and of the tail, and one across phase 10's PE boundary,
     equal to the inputs' records; -m over three ~8 MB files, each
     decoded byte-exact;
 17. the mesh, visible_devices patched to 4 shards that all share the
     one card (each on a CUDA stream of its own): the library calls
     train_counts_sharded (B15, K13's halves) on a (2, 2) mesh,
     encode_blocks_sharded (B19) and align_blocks_sharded (B16) on
     (4, 1), each == the single-device kernels (B15 also on (4, 1) and
     (1, 4), each call's launches and time printed); api.compress(mesh=2) on
     phase 16's input, the trainer's caches emptied: every block payload
     and the model == phase 16's single run, PARAM mesh_n 2 and threads
     2, decompress(mesh=2) byte-exact, K1-K4 launched; a --qlevel 3
     frozen archive of 50,000 reads (use_model=1, a 2^20-row qual table
     past CTX_SHARD_MIN_ENTRIES) decoded with mesh=4 (K18) and mesh=0
     (K4), both byte-exact, timed; SHARD_MIN_POSITIONS = 1 and the
     reference cache emptied: 50,000 reads against ref.fa through a
     ShardedAligner over the 4 shards (K19; no K8/K9), byte-exact, the
     mapped fraction printed, and a 5,000-read cut's archive == the
     device="cpu" one;
 18. --profile: 20,000 reads (adaptive path) compressed and decompressed
     through the CLI, each traced with --profile in a fresh process (as
     a user runs it; its launches are that process's): byte-exact, the
     archive == the one written without it, and each trace's device busy
     share (the union of its kernel, copy and memset records over the
     command's span) and five longest kernels printed.
In each end-to-end run the launch counts are set to 0 just before it and
read just after; a run that aligns prints its aligner kernels' launches
and CUDA-event time by tier (K8 fwd / rc / both / rescue, K9, K14, by
Lp) beside its align_s, and all of them come again as one JSON line
("aligner_runs"); K15's launches by pack mode over phases 4-18 come on a
line of their own, and phase 18's trace summaries as one JSON line
("profile_runs").  The last line is {"ok": true, "device": {...}}; the
line before it holds the kernel table as JSON.

    python3 chip_smoke.py --aligner

runs phases 1-2, phase 3's aligner kernels (K8, K9, K10, K14, K19) with
K8 and K9 also timed at batches of 512-16,384 reads, and phases 8, 11
and 14, each phase 8 and 11 input also through the fused
flow (FASTQUEEZE_FUSED_ALIGN=1, its archive == the classic chain's);
it prints the aligner's kernel times, the batch sweep and the runs as
JSON, then the last line above.

    python3 chip_smoke.py --coders

runs phases 1-2, phase 3's coder kernels (K1-K7, K11-K13) and transfer
packs (K15-K17), and phases 4-5, 12 and 13, then prints their times as
JSON and the last line above;
copied into an older tree's checkout it runs that tree's kernels, so
two trees compare in turns in one call.

    python3 chip_smoke.py --pack-window

runs phases 1-2 and phase 3's K16 (modes 2, 4 and 6) and K10 (Lp 128
and 256 over the seeded genome's packed reference, no index) against
their plain versions, with CUDA-event and device (torch.profiler) times
and bounds, as JSON, then the last line above; copied into an older
tree's checkout it times that tree's K16 and K10 in a fresh process.

    python3 chip_smoke.py --shards

runs phases 1-2 and phase 3's K18 (K4, route (a) at D = 2 and 4, route
(b) in two groups of two shards), K4 at 8192 lanes (several lanes a
thread) and K19 (B = 4096, Lp 128, 4 shards)
against their plain versions, with CUDA-event times and each one's
device time by kernel (torch.profiler: K18's us a wave by route, K19's
ms by phase beside the collectives' kernels and the idle share), as
JSON, then the last line above; copied into an older tree's checkout it
times that tree's K18 and K19 in a fresh process.

    python3 chip_smoke.py --rows

runs phases 1-2 and phase 3's row pass (train_rows, train_rows_sum on
the three tables) against its plain version, with CUDA-event and device
times and bounds, and B15's call split on the three meshes, as JSON, then
the last line above; copied into an older tree's checkout it times that
tree's row pass and B15 call in a fresh process.

    python3 chip_smoke.py --nll

runs phases 1-2 and the frozen trainer's card scorer (pipeline/frozen.py
_CardScorer) at a default compress's shapes: over R_MAIN reads of Markov
qualities (40 values) split into the holdout's halves, the fqz formula's
table (2^16 x 40), a rank chain (k = 3, 64,000 x 40) and a hashed one
(k = 4, 2^18 x 40) trained on the even half by K13's row half with inc
and narrowed (narrow_rows), and K20 (hist_nll) over the odd half's
histogram, and the order-10 seq table (2^20 x 4, u8) over its weights
mantissa-bucketed (mbits 0, 3, 2): each == its plain version bit for
bit and np.sum of K20's terms == frozen._hist_nll_bits, with CUDA-event
and device ms (torch.profiler) beside its bound; then _select_qctx on
that sample with the host scorer and with the card scorer (the same
choice, each one's seconds and its bz2-9 pricing's), as JSON, then the
last line above.

    python3 chip_smoke.py --sass NAME [NAME...] [--out DIR]

builds the kernels and writes the SASS of each kernel whose mangled name
holds a NAME to DIR/sass_<NAME>.txt (cuobjdump -sass; DIR defaults to
./sass) and prints each one's instruction count and CALL instructions
(a 64-bit integer division is a call to a routine).

    python3 chip_smoke.py --coder-loop PROCS ROUNDS [--async] [--own-build]
        [--checked]

runs phase 3's K1 -> K2 -> K3 launches, then K17, K11, K7 on K11's sf,
K15 on the grids' mode 15 and 23 packs and K16 on the grids, and K10 on
phase 3's mates (Lp 128 and 256) over a 4 Mbp cut of the genome,
ROUNDS times in each of PROCS fresh processes and reports which, if any,
fault: under CUDA_LAUNCH_BLOCKING=1,
or with --async synchronizing only where phase 3 does; loading this
process's build, or with --own-build each building the library into its
own empty directory first; with --checked the checked build (every
FQK_CHECK bound live: csrc/check.cuh).
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
GENOME_LEN = 100_000_000
L_MAIN, T_MAIN, READ_LEN = 4096, 6144, 100
R_ADAPT, L_ADAPT, T_ADAPT = 50_000, 2048, 3072
N_IDVAR, L_IDVAR = 3_000_000, 1024
ALIGN_LP = 128
WINDOW_C = 1128                  # min(4096, 2 * 500 + 128): -I 500
R_PAIRS = 150_000
SEEDLESS_AT = np.arange(7, READ_LEN, 14)     # 7 substitutions, no 14-mer
HBM_BPS = 3.35e12                # H100 SXM device memory rate
# the card's 32-bit integer ALU rate: 132 SMs x 64 INT32 lanes (Hopper
# architecture whitepaper) x 1.98 GHz; the CUDA C++ Programming Guide's
# throughput table (compute capability 9.0) gives 32-bit add, shift and
# logical operations 64 results a clock an SM, population count 16
INT_OPS = 132 * 64 * 1.98e9
# a small bacterial genome at 60x; at 1 Mbp (30x) the auto probe's
# 1,536-read prefix maps fewer than the 10 reads it needs and says no
SELFREF_GENOME = 500_000
# phase 17 and its kernel checks: the mesh's shards share the one card
MESH_SHARDS = 4
MESH_DS = (2, 4)           # K18's row shard counts in phase 3
R_CTX = 50_000             # phase 17's --qlevel 3 frozen input
R_SHARD = 50_000           # phase 17's reads through the ShardedAligner


def card() -> str:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card visible (torch.cuda.is_available() "
                 "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
    return smi


def _kernel_name(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    name (e.g. chunk_sf<0>)."""
    import re
    m = re.match(r"_ZN?(.*)", mangled)
    rest, parts = (m.group(1) if m else mangled), []
    while rest[:1].isdigit():
        k = re.match(r"\d+", rest).group()
        parts.append(rest[len(k):len(k) + int(k)])
        rest = rest[len(k) + int(k):]
    names = [x for x in parts if not x.startswith("_GLOBAL__N")]
    name = names[-1] if names else mangled
    targs = re.match(r"I((?:Li-?\d+E)+)E", rest)
    if targs:
        name += "<" + ",".join(re.findall(r"Li(-?\d+)E", targs.group(1))) + ">"
    return name


def _ptxas_summary(log: str) -> str:
    """nvcc -Xptxas -v's lines as 'kernel: registers[, spill bytes][,
    stack bytes]' (a stack frame holds local-memory arrays and spills)."""
    import re
    out, name, spill, stack = [], None, 0, 0
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name, spill, stack = _kernel_name(hit.group(1)), 0, 0
        hit = re.search(r"(\d+) bytes spill stores", line)
        if hit:
            spill = int(hit.group(1))
        hit = re.search(r"(\d+) bytes stack frame", line)
        if hit:
            stack = int(hit.group(1))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            out.append(f"{name}: {hit.group(1)}"
                       + (f", spill {spill}" if spill else "")
                       + (f", stack {stack}" if stack else ""))
            name = None
    return "; ".join(out)


def build():
    """The CUDA kernels, and the native host library (make -C native) the
    pipeline's host stages use, so phase 4 times no set-up."""
    from fastqueeze_tpu_torch.io import native
    from fastqueeze_tpu_torch.ops import kernels
    t0 = time.time()
    info = kernels.build()
    print(f"build: {time.time() - t0:.1f} s wall ({info['path']})")
    print(f"ptxas (kernel: registers[, spill bytes][, stack bytes]): "
          f"{_ptxas_summary(str(info['ptxas']))}")
    t0 = time.time()
    if native.get_lib() is None:
        raise RuntimeError("native host library unavailable (make -C native)")
    print(f"native host library: {time.time() - t0:.1f} s wall")


def _time_ms(fn, reps: int) -> float:
    """Mean ms of `reps` calls; the caller has already run `fn` once (the
    comparison call), which is the warm-up."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _timed(fn):
    """(fn(), the ms of that one call): the plain version's run that a
    comparison reads is also its time (CUDA events around it)."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _graph_ms(fn, reps: int, rounds: int = 10) -> float:
    """Mean device ms a call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed ``rounds`` times between two CUDA events, so the
    wrapper's host work (checks, output fills, the ctypes call), which
    exceeds the warp aligner kernels' device time, stays out; the caller
    has already run ``fn`` once."""
    import torch
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(rounds):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (rounds * reps)


def _device_split(fn, reps: int = 1, tries: int = 3) -> dict:
    """Device ms of each kernel a call of ``fn`` launches, summed by its
    name over ``reps`` calls and divided by them (torch.profiler's CUDA
    activity; the caller has already run ``fn`` once); a session that saw
    no device time is taken again, up to ``tries`` sessions (late in a
    long process the profiler has missed whole sessions); {} where none
    saw any."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = (getattr(ev, "self_device_time_total", None)
                  or getattr(ev, "self_cuda_time_total", 0))
            hit = re.search(r"(\w+)(<[^()]*>)?\(", ev.key)
            name = hit.group(1) if hit else ev.key[:40]
            if us:
                out[name] = out.get(name, 0.0) + us / 1e3 / reps
        if out:
            break
    return out


def _split_row(tag: str, ms: float, fn) -> dict:
    """A kernel's time beside its launches' device ms by kernel name
    (_device_split, over 3 calls); printed."""
    split = _device_split(fn, reps=3)
    print(f"  {tag:30s} {ms:.3f} ms; device ms by kernel (torch.profiler): "
          f"{json.dumps(split)}")
    return {"ms": ms, "device_ms_by_kernel": split}


def _max_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


# The bound of each kernel (the least time the card could take for the
# same work) at the shapes its table row reports: the bytes it must move,
# each input read once and each output written once, over HBM_BPS, or its
# integer operations over INT_OPS, whichever is larger.  Filled by phase
# 3: kernel -> (bytes, operations, library call ms or None).
BOUNDS = {}
# K14's comparison, by shape: K8's rescue and K9 launched separately on
# the same rows (ms); no single PyTorch call computes this function
PAIR_MS = {}
# integer operations a symbol (a table entry for K1, a grid slot for K3)
# on each coder kernel's work, counted from its inner loop: context
# update, table gather, rANS step and renormalisation; the adaptive walk
# adds the row quantization and the count update
_OPS = {"quant_pack": 4, "frozen_encode_lanes": 30, "compact_words": 2,
        "frozen_decode": 25, "adapt_encode_walk": 30, "rans_encode_sf": 20,
        "adapt_decode": 40, "semi_encode_walk": 16, "semi_decode": 35,
        "train_counts": 12}
SEMI_CHUNK = 64
# a frame word of a gapless verify: what the comparison needs, whatever
# implements it: XOR, the 2-bit fold (a shift and one LOP3 with the
# folded mask) and the add on the ALU, and one popcount at a quarter of
# the ALU's rate on a unit of its own; the larger of the two times, 4
# ALU-rate operations (4 ALU ops, or 1 popcount x 4)
_VERIFY_OPS = 4


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound_row(name: str) -> dict:
    b, ops, lib = BOUNDS[name]
    tb, to = b / HBM_BPS * 1e3, ops / INT_OPS * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_peak": ("3.35 TB/s HBM" if tb >= to
                           else f"{INT_OPS / 1e12:.1f} T int32 op/s (ALU)"),
            "library_ms": lib}


def _seed_work(ix, cfg, codes, dege, lens):
    """What one strand's seed search needs on these reads: (sampled valid
    seeds, listed candidates, candidates verified over all W+1 words) per
    read, from the index: the n_seeds least frequent valid seeds' lists,
    each cut at n_cand; with the probe prefilter (lists over 2K), two
    probe words for every candidate and a full verify of the top K."""
    import torch
    B, Lp = codes.shape
    k = cfg.k
    ps = torch.arange(0, Lp - k + 1, cfg.stride, device=codes.device)
    kv = torch.zeros((B, len(ps)), dtype=torch.int64, device=codes.device)
    for j in range(k):
        kv = (kv << 2) | codes.long()[:, ps + j]
    cs = torch.nn.functional.pad(torch.cumsum(dege.long(), 1), (1, 0))
    ok = (ps[None, :] <= lens.long()[:, None] - k) & (cs[:, ps + k]
                                                      == cs[:, ps])
    keys, offs = ix.keys.long(), ix.offsets.long()
    ii = torch.clamp(torch.searchsorted(keys, kv), max=keys.numel() - 1)
    found = ok & (keys[ii] == kv)
    occ = torch.where(found, offs[ii + 1] - offs[ii], 1 << 40)
    occ = torch.sort(occ, 1).values[:, :cfg.n_seeds]
    cands = torch.where(occ < (1 << 40), torch.clamp(occ, max=cfg.n_cand),
                        0).sum(1)
    W = Lp // 16
    pre = (cands > 2 * cfg.probe_k) & (W > 3)
    verified = torch.where(pre, torch.clamp(cands, max=cfg.probe_k), cands)
    return ok.sum(1), cands, verified, pre


def _align_bound(ix, cfg, codes, dege, lens, outs, strands=1,
                 extra_ops=0, extra_bytes=0):
    """(bytes, operations) of a seed-search kernel: per strand and read,
    the key build and bucket search of every valid sampled seed, the
    positions of the listed candidates, the probe words, the W+1 words of
    every full verify, plus ``extra_*`` a strand-read."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    W = codes.shape[1] // 16
    grids = [(codes, dege)]
    if strands == 2:
        grids.append(kernels._rc_grid(codes, dege, lens.long()))
    ops = byts = 0
    for c, d in grids:
        n_seed, cands, verified, pre = _seed_work(ix, cfg, c, d, lens)
        ops += int((n_seed * (2 * cfg.k + 6 * ix.search_steps)).sum())
        ops += int((torch.where(pre, cands * 2, 0)
                    + verified * (W + 1)).sum()) * _VERIFY_OPS
        byts += int((n_seed * (8 + 8 + ix.keys.element_size())).sum())
        byts += int((cands * 4 + torch.where(pre, cands * 8, 0)
                     + verified * (W + 1) * 4).sum())
        ops += extra_ops * codes.shape[0]
        byts += extra_bytes * codes.shape[0]
    return byts + _nbytes(codes, dege, lens, *outs), ops


def _wpad(out, k: int):
    """The first k compacted words in a zero-padded power-of-two buffer
    (at least 1024), as the engine hands them to the decoders."""
    import torch
    W = 1024
    while W < k + 8:
        W <<= 1
    wpad = torch.zeros(W, dtype=torch.int16, device=out.device)
    wpad[:k] = out[:k]
    return wpad


R_MAIN = (T_MAIN * 7 // 8 // READ_LEN) * L_MAIN  # 217,088 reads -> T 6144


def _coder_cases(dev):
    """Phase 3's frozen-coder inputs, in order, from SEED: per model (the
    order-10 seq table and two qual tables) its tag, the model, the lane
    layout of R_MAIN x 100 bp reads, the flat symbols, and on ``dev`` the
    (T, L) symbol grid, a random count table and the counts grid."""
    import torch
    from fastqueeze_tpu_torch.models.base import QualModel, SeqModel
    from fastqueeze_tpu_torch.ops import engine
    from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid
    rng = np.random.default_rng(SEED)
    counts = np.full(R_MAIN, READ_LEN, np.int64)
    cg = torch.from_numpy(engine._counts_grid(counts, L_MAIN)).to(dev)
    models = {
        "seq_order10": SeqModel(alphabet=4, init=3, inc=1, cap=253,
                                order=10),
        "qual_fqz_A48": QualModel(alphabet=48, qlevel=2),
        "qual_k4_hash16_pos3": QualModel(alphabet=48, k=4, ctx_base=40,
                                         hash_bits=16, pos_bits=3),
    }
    for tag, m in models.items():
        table = rng.integers(1, 254 if m.alphabet == 4 else 400,
                             (m.n_ctx, m.alphabet)).astype(np.int32)
        syms = rng.integers(0, m.alphabet, R_MAIN * READ_LEN).astype(np.uint8)
        lay = make_layout(counts, L_MAIN)
        assert (lay.T, lay.L) == (T_MAIN, L_MAIN), (lay.T, lay.L)
        yield (tag, m, lay, syms, torch.from_numpy(to_grid(lay, syms)).to(dev),
               torch.from_numpy(table).to(dev), cg)


# K4's thread-block cluster at L_MAIN and its time a wave, by table
K4_SHAPE = {}
# K2's time by table, with its kernels' device ms (forward: the chunk
# walk's passes; reverse: the rANS chain)
K2_SPLIT = {}
# K12 by stream and start: its cluster, time a wave, kernels' device ms
# and the boundary passes' share
SEMI_SHAPE = {}
# K11 by stream and start, K17 by grid, K3 on the seq table's words:
# time and kernels' device ms
K11_SPLIT = {}
K17_SPLIT = {}
K3_SPLIT = {}
# K15 and K16 by grid and mode, K1 by table, K10 by Lp: time and
# kernels' device ms
K15_SPLIT = {}
K16_SPLIT = {}
K1_SPLIT = {}
K10_SPLIT = {}
# K15's launches by pack mode over the main path's runs (_read_counts)
UNPACK_BY_MODE = {}
# the reverse chains (K7; K2's reverse pass): ms at two depths of lanes
# that are live to the last wave, ns a step (the slope), and the chain
# bound at phase 3's shape
CHAIN = {}
# rev_step (csrc/lane_walk.cuh) from x to the next x in the SASS of
# rans_encode_sf and encode_reverse: ISETP (the emit, taking the f < 2^14
# predicate), @P SHF (x >> 16), IMAD.HI (q), IMAD (x - (q + 1) d; the
# update x + start + (q + 1) (M - d) beside it), SHF (its sign), IMAD
# (the update less M - d where q was exact)
_CHAIN_OPS = 6
_OP_CYCLES = 4    # the least stall count ptxas sets between two of them
                  # (IMAD.HI before its dependent IMAD)


def _sm_clock_mhz() -> float:
    """The card's top SM clock (nvidia-smi clocks.max.sm, MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    return float(out[0])


def _chain(name: str, steps: int, run, depths, ms_of) -> dict:
    """A reverse chain's ns a step: ``run(T)`` (the kernel on the first T
    waves of its grid, every lane live to the last; it checks the result
    against the plain version) at the two ``depths``, ``ms_of(T)`` its
    time there; the slope of ms against T, and the chain bound of
    ``steps`` (the longest lane at phase 3's shape) steps of _CHAIN_OPS
    dependent operations of _OP_CYCLES cycles at the top SM clock."""
    import re
    ms = {}
    for T in depths:
        run(T)
        ms[T] = ms_of(T)
    hi, lo = max(depths), min(depths)
    clock = _sm_clock_mhz()
    kernel = {"rans_encode_sf": "rans_encode_sf",
              "frozen_encode_lanes": "encode_reverse"}[name]
    try:
        loop = [_chain_loop(f) for f in _sass_functions()
                if re.match(rf"\s*Function : \S*{kernel}", f)]
    except (OSError, subprocess.CalledProcessError) as exc:
        loop = [f"not read ({exc})"]
    out = {"ms_by_waves": ms,
           "ns_per_step": (ms[hi] - ms[lo]) / (hi - lo) * 1e6,
           "steps": steps, "sm_clock_max_mhz": clock,
           "chain_bound_ms": steps * _CHAIN_OPS * _OP_CYCLES / (clock * 1e3),
           "sass": loop}
    print(f"  {name} chain: {json.dumps(out)}")
    CHAIN[name] = out
    return out


def _k4_shape(m, ms: float, tag: str) -> dict:
    """The cluster K4 ran for L_MAIN lanes (kernels.frozen_decode_shape:
    cudaOccupancyMaxActiveClusters says how many fit the card), printed
    with the kernel's time a wave."""
    from fastqueeze_tpu_torch.ops import kernels
    shape = dict(kernels.frozen_decode_shape(L_MAIN, m),
                 ms_per_wave=ms / T_MAIN, ms=ms)
    if shape["max_active_clusters"] < 1:
        raise AssertionError(f"K4's cluster {shape} does not fit the card")
    print(f"  {tag:22s} frozen_decode cluster: {shape['ctas']} CTAs x "
          f"{shape['threads']} threads, {shape['lanes_per_thread']} lane(s) "
          f"a thread, {shape['max_active_clusters']} such clusters fit the "
          f"card; {ms:.3f} ms = {shape['ms_per_wave'] * 1e3:.3f} us a wave")
    return shape


def _k2_chain(g, packed, m, steps: int) -> None:
    """K2's reverse pass (torch.profiler's device ms of encode_reverse) on
    the first T = 4096 and 2048 waves of the frozen grid, each lane one
    read of T symbols, against the plain version."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    cgs = {T: torch.full((1, g.shape[1]), T, dtype=torch.int32,
                         device=g.device) for T in (4096, 2048)}

    def run(T):
        got = kernels.frozen_encode_lanes(g[:T], cgs[T], packed, m)
        want = kernels.frozen_encode_lanes_plain(g[:T], cgs[T], packed, m)
        if any(not torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K2 at T = {T} differs from its plain "
                                 f"version")

    def ms_of(T):
        # the profiler has missed a session's kernels now and then: a
        # session of 3 calls, taken again if it saw no reverse pass
        for _ in range(3):
            split = _device_split(lambda: kernels.frozen_encode_lanes(
                g[:T], cgs[T], packed, m), reps=3)
            if "encode_reverse" in split:
                return split["encode_reverse"]
        raise RuntimeError(f"torch.profiler saw no encode_reverse at T = {T}")

    _chain("frozen_encode_lanes", steps, run, tuple(cgs), ms_of)


def check_kernels():
    """Each kernel vs its plain version, same inputs on the card."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    from fastqueeze_tpu_torch.ops.lanes import to_grid
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = {}
    for tag, m, lay, syms, g, c, cg in _coder_cases(dev):
        r = {}
        k1 = kernels.quant_pack(c)
        p1 = kernels.quant_pack_plain(c)
        r["quant_pack"] = (max(_max_err(k1[0], p1[0]), _max_err(k1[1], p1[1])),
                           _time_ms(lambda: kernels.quant_pack(c), 5),
                           _time_ms(lambda: kernels.quant_pack_plain(c), 1))
        cum, packed = k1
        k2 = kernels.frozen_encode_lanes(g, cg, packed, m)
        p2, p2_ms = _timed(lambda: kernels.frozen_encode_lanes_plain(
            g, cg, packed, m))
        r["frozen_encode_lanes"] = (
            max(_max_err(a, b) for a, b in zip(k2, p2)),
            _time_ms(lambda: kernels.frozen_encode_lanes(g, cg, packed, m), 3),
            p2_ms)
        split = _device_split(lambda: kernels.frozen_encode_lanes(
            g, cg, packed, m))
        rev = split.get("encode_reverse", 0.0)
        K2_SPLIT[tag] = {"ms": r["frozen_encode_lanes"][1],
                         "forward_ms": sum(split.values()) - rev,
                         "reverse_ms": rev, "device_ms_by_kernel": split}
        print(f"  {tag:22s} frozen_encode_lanes device ms by kernel "
              f"(torch.profiler): {json.dumps(split)}")
        words, emit, states = k2
        k3 = kernels.compact_words(words, emit)
        p3 = kernels.compact_words_plain(words, emit)
        n = int(p3[1].item())
        r["compact_words"] = (
            max(_max_err(k3[1], p3[1]), _max_err(k3[0][:n], p3[0][:n])),
            _time_ms(lambda: kernels.compact_words(words, emit), 5),
            _time_ms(lambda: kernels.compact_words_plain(words, emit), 1))
        if tag == "seq_order10":
            K3_SPLIT[tag] = _split_row(
                f"{tag}_compact_words", r["compact_words"][1],
                lambda: kernels.compact_words(words, emit))
            _k2_chain(g, packed, m, int(cg.long().sum(0).max()))
        wpad = _wpad(k3[0], n)
        k4 = kernels.frozen_decode(states, wpad, cg, T_MAIN, cum, m)
        p4, p4_ms = _timed(lambda: kernels.frozen_decode_plain(
            states, wpad, cg, T_MAIN, cum, m))
        r["frozen_decode"] = (
            _max_err(k4, p4),
            _time_ms(lambda: kernels.frozen_decode(states, wpad, cg, T_MAIN,
                                                   cum, m), 2),
            p4_ms)
        if not torch.equal(k4.cpu(), torch.from_numpy(to_grid(lay, syms))):
            raise AssertionError(f"{tag}: decode does not invert encode")
        K4_SHAPE[tag] = _k4_shape(m, r["frozen_decode"][1], tag)
        if tag == "seq_order10":
            nsym = R_MAIN * READ_LEN

            def select():
                return torch.masked_select(words, emit.bool()), emit.sum()

            sel = select()[0]
            if not torch.equal(sel, k3[0][:n]):
                raise AssertionError("masked_select order != K3's (wave, "
                                     "lane) order")
            print("  torch.masked_select(words, emit) == K3's dense prefix "
                  "((wave, lane) order)")
            BOUNDS.update({
                "quant_pack": (_nbytes(c, *k1),
                               _OPS["quant_pack"] * c.numel(), None),
                "frozen_encode_lanes": (_nbytes(g, cg, packed, *k2),
                                        _OPS["frozen_encode_lanes"] * nsym,
                                        None),
                "compact_words": (_nbytes(words, emit) + 2 * n + 4,
                                  _OPS["compact_words"] * words.numel(),
                                  _time_ms(select, 5)),
                "frozen_decode": (_nbytes(states, cg, cum, k4) + 2 * n,
                                  _OPS["frozen_decode"] * nsym, None)})
        for name, (err, ms, pms) in r.items():
            print(f"  {tag:22s} {name:20s} max_abs_err {err}  kernel "
                  f"{ms:10.3f} ms  plain {pms:10.3f} ms")
            if err:
                raise AssertionError(f"{tag} {name}: kernel differs from "
                                     f"its plain version ({err})")
        rows[tag] = r
    return rows


COPY = {}         # phase 3's host<->device copies of one stream (ms, bytes)
_DENSE = {"seq": 2, "markov40": 6, "markov14": 4, "uniform48": 6}


def _copy_ms(arr: np.ndarray, dev, reps: int = 5):
    """(H2D ms, D2H ms) of ``arr`` as the engine copies it: from pageable
    host memory (torch.from_numpy(...).to) and back (.cpu())."""
    import torch
    t = torch.from_numpy(arr).to(dev)
    h2d = _time_ms(lambda: torch.from_numpy(arr).to(dev), reps)
    d2h = _time_ms(lambda: t.cpu(), reps)
    return h2d, d2h


def _qual_grids(dev, lay):
    """Phase 3's quality grids at the frozen shape: first-order Markov
    qualities (_markov_quals, 40 values: the 6-bit packs, 15 and 23),
    the same binned to 14 values (the 4-bit pack) and the uniform grid
    of the qual_fqz_A48 table (flat: K17's sidecar overflows)."""
    import torch
    from fastqueeze_tpu_torch.ops.lanes import to_grid
    q = (_markov_quals(np.random.default_rng(SEED + 11), R_MAIN)
         - 35).reshape(-1)
    uni = np.random.default_rng(SEED + 12).integers(0, 48, q.size)
    return {name: torch.from_numpy(to_grid(lay, v.astype(np.uint8))).to(dev)
            for name, v in (("markov40", q), ("markov14", q // 3),
                            ("uniform48", uni))}


def _sent_pack(host: np.ndarray, mode: int):
    """The host's sentinel pack of a (T, L) grid in mode 15 (its top 15
    symbols as nibbles) or 23 (its top 3 as 2-bit codes): (packed,
    sidecar, top)."""
    from fastqueeze_tpu_torch.ops import engine
    sent = 15 if mode == 15 else 3
    cnt = np.bincount(host.reshape(-1), minlength=64)
    top = np.argsort(-cnt, kind="stable")[:sent]
    top = top[cnt[top] > 0].astype(np.uint8)
    packed, side = engine._pack_sent_host(
        host, top, sent,
        engine._pack4_host if mode == 15 else engine._pack2_host)
    return packed, side, top


def _pack_row(rows, key, name, got, want, run, plain, reps=10) -> None:
    """A pack's outputs against its plain version's (raises on any
    difference), and both times (CUDA events), into rows[key][name]."""
    err = max(_max_err(a, b) for a, b in zip(got, want))
    rows.setdefault(key, {})[name] = (err, _time_ms(run, reps),
                                      _time_ms(plain, 1))
    e, ms, pms = rows[key][name]
    print(f"  {key:22s} {name:12s} max_abs_err {e}  kernel {ms:10.3f} "
          f"ms  plain {pms:10.3f} ms")
    if e:
        raise AssertionError(f"{key} {name}: kernel differs from its "
                             f"plain version ({e})")


def _check_pack_grid(key, g, mode, packed, row, rows) -> None:
    """K16 on a phase 3 grid in ``mode`` == the host pack and its plain
    version; its time, device time (torch.profiler) and bound: the grid
    in, the pack out."""
    from fastqueeze_tpu_torch.ops import kernels
    k16 = kernels.pack_grid(g, mode)
    if not np.array_equal(k16.cpu().numpy(), packed):
        raise AssertionError(f"{key}: K16 != the host pack")
    row(key, "pack_grid", [k16], [kernels.pack_grid_plain(g, mode)],
        lambda: kernels.pack_grid(g, mode),
        lambda: kernels.pack_grid_plain(g, mode))
    K16_SPLIT[key] = _split_row(f"{key}_pack_grid",
                                rows[key]["pack_grid"][1],
                                lambda: kernels.pack_grid(g, mode))
    BOUNDS[f"pack_grid_{key}"] = (_nbytes(g, k16), 3 * g.numel(), None)
    if key == "markov40_mode6":
        BOUNDS["pack_grid"] = BOUNDS[f"pack_grid_{key}"]


def check_pack_kernels():
    """K15, K16 and K17 at the frozen shape (L = 4096, T = 6144) against
    their plain versions, bit-equal: the seq grid in mode 2, the Markov
    quality grid in modes 6, 15 and 23 (the host's sentinel packs with its
    top 15 and top 3), its 14-value binning in mode 4, K17 on the Markov
    and the uniform grids; K1 on the seq table as i32 and u8, the qual
    table as u16 and a 2^20 x 41 u16 table; K15's and K1's device time
    by kernel, bound and library parts (torch.cumsum); the copy of one
    stream each way, packed and unpacked."""
    import torch
    from fastqueeze_tpu_torch.ops import engine, kernels
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = list(_coder_cases(dev))
    tag, m, lay, _, seq_g, seq_table, cg = cases[0]
    qual_table = cases[1][5]
    del cases
    grids = dict(_qual_grids(dev, lay), seq=seq_g)
    rows = {}

    def row(key, name, got, want, run, plain, reps=10):
        _pack_row(rows, key, name, got, want, run, plain, reps)

    for gname, mode in (("seq", 2), ("markov40", 6), ("markov40", 15),
                        ("markov40", 23), ("markov14", 4),
                        ("uniform48", 6)):
        g = grids[gname]
        host = g.cpu().numpy()
        if mode in (15, 23):
            packed, side, top = _sent_pack(host, mode)
            side_d = torch.from_numpy(side).to(dev)
        else:
            packed, side, side_d = engine._pack_host(host, mode), None, None
        pk = torch.from_numpy(packed).to(dev)
        key = f"{gname}_mode{mode}"
        k15 = kernels.unpack_grid(pk, mode, side_d)
        if not torch.equal(k15, g):
            raise AssertionError(f"{key}: K15 does not restore the grid")
        row(key, "unpack_grid", [k15],
            [kernels.unpack_grid_plain(pk, mode, side_d)],
            lambda: kernels.unpack_grid(pk, mode, side_d),
            lambda: kernels.unpack_grid_plain(pk, mode, side_d))
        K15_SPLIT[key] = _split_row(
            f"{key}_unpack_grid", rows[key]["unpack_grid"][1],
            lambda: kernels.unpack_grid(pk, mode, side_d))
        # the bytes K15 must move: the pack in, the grid out, and in the
        # sentinel modes the top table and one sidecar byte a sentinel
        n_sent = 0
        if mode in (15, 23):
            exc = torch.from_numpy(~np.isin(host, top)).to(dev).reshape(-1)
            n_sent = int(exc.sum().item())
            PAIR_MS[f"unpack_grid_cumsum_{key}"] = _time_ms(
                lambda: torch.cumsum(exc, 0, dtype=torch.int32), 10)
            print(f"  {key}: {n_sent} sentinels; library part: torch.cumsum "
                  f"of the flat sentinel mask (the ranks) "
                  f"{PAIR_MS[f'unpack_grid_cumsum_{key}']:.4f} ms")
            del exc
        BOUNDS[f"unpack_grid_{key}"] = (
            _nbytes(pk, k15) + (16 + n_sent if side_d is not None else 0),
            3 * g.numel(), None)
        if gname == "seq":
            BOUNDS["unpack_grid"] = BOUNDS[f"unpack_grid_{key}"]
        if mode in (2, 4, 6):
            _check_pack_grid(key, g, mode, packed, row, rows)
        picks = engine._pack_for_upload(host, _DENSE[gname])[0]
        print(f"  {key}: host pack {packed.nbytes} B"
              + (f" + sidecar {side.nbytes} B" if side is not None else "")
              + f" (grid {host.nbytes} B); the encode's upload picks mode "
              f"{picks}")
        if mode == 6:
            k17 = kernels.pack15(g, cg)
            n_exc = int(k17[2].item())
            row(f"{gname}_pack15", "pack15", k17,
                kernels.pack15_plain(g, cg),
                lambda: kernels.pack15(g, cg),
                lambda: kernels.pack15_plain(g, cg))
            K17_SPLIT[gname] = _split_row(
                f"{gname}_pack15", rows[f"{gname}_pack15"]["pack15"][1],
                lambda: kernels.pack15(g, cg))
            cap = g.numel() // 4
            print(f"  {gname}_pack15: {n_exc} exceptions (cap {cap}); the "
                  f"decode copies "
                  f"{'the nibbles + sidecar' if n_exc <= cap else 'the 6-bit pack'}")
            if gname == "markov40":
                # the two library calls that compute parts of K17: the
                # valid slots' histogram, and the exceptions in scan order
                valid = (torch.arange(g.shape[0], device=dev)[:, None]
                         < cg.long().sum(0)[None, :])
                flat = g[valid].long()
                exc = valid & ~torch.isin(g, k17[1][:15])

                def hist():
                    return torch.bincount(flat, minlength=64)

                def select():
                    return torch.masked_select(g, exc)

                if not torch.equal(select()[:cap], k17[1][16:16 + min(
                        n_exc, cap)]):
                    raise AssertionError("masked_select != K17's exceptions")
                BOUNDS["pack15"] = (
                    _nbytes(g, cg, k17[0], k17[2]) + 16 + min(n_exc, cap),
                    8 * g.numel(), None)
                PAIR_MS["pack15_bincount"] = _time_ms(hist, 10)
                PAIR_MS["pack15_masked_select"] = _time_ms(select, 10)
                print(f"  pack15 library parts: torch.bincount "
                      f"{PAIR_MS['pack15_bincount']:.3f} ms, "
                      f"torch.masked_select "
                      f"{PAIR_MS['pack15_masked_select']:.3f} ms")
                del flat, valid, exc

    # K1 on the tables as they travel (i32 and u8 seq, u16 qual) and on
    # phase 17's --qlevel 3 table shape (2^20 x 41, u16 counts up to
    # 65,535); each beside torch.cumsum(dim=1), the row scan alone
    q3 = torch.from_numpy(np.random.default_rng(SEED + 13).integers(
        1, 65536, (1 << 20, 41)).astype(np.uint16).view(np.int16)).to(dev)
    for name, table, narrow in (
            ("seq_i32", seq_table, seq_table),
            ("seq_u8", seq_table, seq_table.to(torch.uint8)),
            ("qual_u16", qual_table, qual_table.to(torch.int16)),
            ("q3_u16", q3.int() & 0xFFFF, q3)):
        want = kernels.quant_pack(table)
        got = kernels.quant_pack(narrow)
        key = f"quant_pack_{name}"
        row(key, "quant_pack", got, kernels.quant_pack_plain(narrow),
            lambda: kernels.quant_pack(narrow),
            lambda: kernels.quant_pack_plain(narrow), 5)
        if any(not torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K1 {name} != K1 on the int32 table")
        K1_SPLIT[name] = _split_row(key, rows[key]["quant_pack"][1],
                                    lambda: kernels.quant_pack(narrow))
        BOUNDS[key] = (_nbytes(narrow, *got),
                       _OPS["quant_pack"] * narrow.numel(), None)
        PAIR_MS[f"quant_pack_cumsum_{name}"] = _time_ms(
            lambda: torch.cumsum(narrow, 1, dtype=torch.int32), 5)
        print(f"  {key}: {tuple(narrow.shape)} {narrow.dtype}; library "
              f"part: torch.cumsum(dim=1) (the row scan) "
              f"{PAIR_MS[f'quant_pack_cumsum_{name}']:.4f} ms; "
              f"{_bound_row(key)}")
        del want, got
    del q3

    # one stream's copies: unpacked, and packed as the engine ships it
    for gname, modes in (("seq", (0, 2)), ("markov40", (0, 6, 15))):
        host = grids[gname].cpu().numpy()
        for mode in modes:
            if mode == 15:
                nib, side, n_exc = kernels.pack15(grids[gname], cg)
                arrs = [nib.cpu().numpy(),
                        side[:16 + int(n_exc.item())].cpu().numpy()]
            else:
                arrs = [engine._pack_host(host, mode)]
            ms = [_copy_ms(a, dev) for a in arrs]
            COPY[f"{gname}_mode{mode}"] = {
                "bytes": sum(a.nbytes for a in arrs),
                "h2d_ms": sum(h for h, _ in ms),
                "d2h_ms": sum(d for _, d in ms)}
            print(f"  copy {gname} mode {mode}: {COPY[f'{gname}_mode{mode}']}")
    return rows


# per adaptive stream of phase 3: K6's cluster and time a wave, K5's
# heaviest row (the most wave groups of any row: its walk's chain)
ADAPT_SHAPE = {}


def _row_groups(g, cg, m):
    """(wave groups of the row with the most, events of the row with the
    most): what K5's row walk does in order on its longest chain."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    T = g.shape[0]
    valid, aux = kernels._walk_aux(T, cg, None)
    c = m.context_grids(g, aux)
    keys = torch.unique(c[valid] * T + torch.nonzero(valid)[:, 0])
    groups = torch.unique(keys // T, return_counts=True)[1]
    events = torch.unique(c[valid], return_counts=True)[1]
    return int(groups.max()), int(events.max())


def _adapt_shape(tag, m, L, T, k5_ms, k6_ms, g, cg) -> dict:
    from fastqueeze_tpu_torch.ops import kernels
    shape = dict(kernels.adapt_decode_shape(L, m), k6_ms=k6_ms,
                 k6_us_per_wave=k6_ms / T * 1e3, k5_ms=k5_ms)
    if shape["max_active_clusters"] < 1:
        raise AssertionError(f"K6's cluster {shape} does not fit the card")
    shape["k5_heaviest_row_groups"], shape["k5_heaviest_row_events"] = (
        _row_groups(g, cg, m))
    print(f"  {tag:22s} adapt_decode cluster: {shape['ctas']} CTAs x "
          f"{shape['threads']} threads, {shape['lanes_per_thread']} lane(s) "
          f"a thread, {shape['max_active_clusters']} such clusters fit the "
          f"card; {k6_ms:.3f} ms = {shape['k6_us_per_wave']:.3f} us a wave; "
          f"adapt_encode_walk {k5_ms:.3f} ms, heaviest row "
          f"{shape['k5_heaviest_row_groups']} wave groups of {T} "
          f"({shape['k5_heaviest_row_events']} events on the busiest row)")
    return shape


def _k7_chain(sf, steps: int) -> None:
    """K7 (CUDA events) on the first T = 2048 and 1024 waves of K5's seq
    grid, every lane of its 2048 live there, against the plain version."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    cgs = {T: torch.full((1, sf.shape[1]), T, dtype=torch.int32,
                         device=sf.device) for T in (2048, 1024)}

    def run(T):
        got = kernels.rans_encode_sf(sf[:T], cgs[T])
        want = kernels.rans_encode_sf_plain(sf[:T], cgs[T])
        if any(not torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K7 at T = {T} differs from its plain "
                                 f"version")

    _chain("rans_encode_sf", steps, run, tuple(cgs),
           lambda T: _time_ms(lambda: kernels.rans_encode_sf(sf[:T], cgs[T]),
                              5))


def check_adaptive_kernels():
    """K5 -> K7 -> K3 -> K6 vs the plain versions, same inputs on the
    card; the decode must invert the encode."""
    import torch
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.models.base import (QualModel, SeqModel,
                                                  byte_model)
    from fastqueeze_tpu_torch.ops import engine, kernels
    from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid
    from fastqueeze_tpu_torch.pipeline.blockcodec import _chunk_counts
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED + 2)
    reads = np.full(R_ADAPT, READ_LEN, np.int64)
    p = CodecParams()
    streams = {
        "adapt_seq_order10": (SeqModel(alphabet=4, init=3, inc=1, cap=253,
                                       order=10), reads),
        "qual_fqz_A40_q2": (QualModel(alphabet=40, init=1, inc=8, cap=8192,
                                      qlevel=2), reads),
        "qual_fqz_A40_q3": (QualModel(alphabet=40, init=1, inc=8, cap=8192,
                                      qlevel=3), reads),
        "idvar_order1_byte": (byte_model(p), _chunk_counts(N_IDVAR)),
    }
    rows = {}
    for tag, (m, counts) in streams.items():
        n = int(counts.sum())
        L = p.n_lanes(n)
        lay = make_layout(counts, L)
        want_shape = (T_ADAPT, L_IDVAR if tag.startswith("idvar")
                      else L_ADAPT)
        assert (lay.T, lay.L) == want_shape, (tag, lay.T, lay.L)
        if m.alphabet == 40:     # drifting ranks: realistic fqz contexts
            syms = np.clip(np.cumsum(rng.integers(-2, 3, n)) % 60, 0, 39)
        else:
            syms = rng.integers(0, m.alphabet, n)
        g = torch.from_numpy(to_grid(lay, syms.astype(np.uint8))).to(dev)
        cg = torch.from_numpy(engine._counts_grid(counts, L)).to(dev)
        nh = engine._n_halve(m, L)
        r = {}
        sf = kernels.adapt_encode_walk(g, cg, m, nh)
        sf_p, p5_ms = _timed(lambda: kernels.adapt_encode_walk_plain(
            g, cg, m, nh))
        r["adapt_encode_walk"] = (
            _max_err(sf, sf_p),
            _time_ms(lambda: kernels.adapt_encode_walk(g, cg, m, nh), 5),
            p5_ms)
        k7 = kernels.rans_encode_sf(sf, cg)
        p7, p7_ms = _timed(lambda: kernels.rans_encode_sf_plain(sf, cg))
        r["rans_encode_sf"] = (
            max(_max_err(a, b) for a, b in zip(k7, p7)),
            _time_ms(lambda: kernels.rans_encode_sf(sf, cg), 3), p7_ms)
        words, emit, states = k7
        if tag == "adapt_seq_order10":
            _k7_chain(sf, int(cg.long().sum(0).max()))
        out, cnt = kernels.compact_words(words, emit)
        k = int(cnt.item())
        wpad = _wpad(out, k)
        k6 = kernels.adapt_decode(states, wpad, cg, lay.T, m, nh)
        p6, p6_ms = _timed(lambda: kernels.adapt_decode_plain(
            states, wpad, cg, lay.T, m, nh))
        r["adapt_decode"] = (
            _max_err(k6, p6),
            _time_ms(lambda: kernels.adapt_decode(states, wpad, cg, lay.T,
                                                  m, nh), 5),
            p6_ms)
        if not torch.equal(k6, g):
            raise AssertionError(f"{tag}: adaptive decode does not invert "
                                 f"encode")
        if tag == "adapt_seq_order10":
            BOUNDS.update({
                "adapt_encode_walk": (_nbytes(g, cg, sf),
                                      _OPS["adapt_encode_walk"] * n, None),
                "rans_encode_sf": (_nbytes(sf, cg, *k7),
                                   _OPS["rans_encode_sf"] * n, None),
                "adapt_decode": (_nbytes(states, cg, k6) + 2 * k,
                                 _OPS["adapt_decode"] * n, None)})
        print(f"  {tag} (L = {L}, T = {lay.T}, {n} symbols, {k} words)")
        for name, (err, ms, pms) in r.items():
            print(f"  {tag:22s} {name:20s} max_abs_err {err}  kernel "
                  f"{ms:10.3f} ms  plain {pms:10.3f} ms")
            if err:
                raise AssertionError(f"{tag} {name}: kernel differs from "
                                     f"its plain version ({err})")
        ADAPT_SHAPE[tag] = _adapt_shape(
            tag, m, L, lay.T, r["adapt_encode_walk"][1],
            r["adapt_decode"][1], g, cg)
        rows[tag] = r
    return rows


def _train_qual(R: int, lay, cg) -> dict:
    """K13's histogram half on phase 4's quality model over Markov
    qualities (repeating contexts: same-address atomics) at the frozen
    shape, against its plain version and torch.bincount of its keys."""
    import torch
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.models.base import qual_model_for
    from fastqueeze_tpu_torch.ops import kernels
    from fastqueeze_tpu_torch.ops.lanes import to_grid
    m = qual_model_for(CodecParams(), 40)
    rng = np.random.default_rng(SEED + 17)
    q = (_markov_quals(rng, R) - 35).astype(np.uint8).reshape(-1)
    g = torch.from_numpy(to_grid(lay, q)).to(cg.device)
    h = torch.zeros((m.n_ctx, m.alphabet), dtype=torch.int32,
                    device=cg.device)
    kernels.train_hist(g, cg, m, h)
    want = kernels.train_hist_plain(g, cg, m, torch.zeros_like(h))
    if not torch.equal(h, want):
        raise AssertionError("train_hist (qualities) != its plain version")
    valid, aux = kernels.device_aux_plain(g.shape[0], cg)
    flat = (m.context_grids(g, aux).long() * m.alphabet + g.long())[valid]
    out = {"ms": _time_ms(lambda: kernels.train_hist(
               g, cg, m, h.zero_()), 5),
           "bincount_ms": _time_ms(lambda: torch.bincount(
               flat, minlength=m.n_ctx * m.alphabet), 5)}
    print(f"  train_qual_markov40 (n_ctx {m.n_ctx} x 40) train_hist "
          f"{out['ms']:.3f} ms, torch.bincount {out['bincount_ms']:.3f} ms;"
          f" == its plain version")
    return out


def _semi_shape(tag, m, ms: float, dec) -> dict:
    """K12's cluster at L_ADAPT (absent from trees before the cluster
    design, which ``--coders`` also runs), its time a wave and its
    kernels' device ms: the share of the chunk boundaries' table
    passes."""
    from fastqueeze_tpu_torch.ops import kernels
    query = getattr(kernels, "semi_decode_shape", None)
    split = _device_split(dec)
    table = sum(v for k, v in split.items()      # the parent's: table pass
                if k in ("boundary_rows", "semi_table_pass"))
    out = dict(query(L_ADAPT, m) if query else {}, ms=ms,
               us_per_wave=ms / T_ADAPT * 1e3,
               boundary_share=table / sum(split.values()) if split else None,
               device_ms_by_kernel=split)
    cluster = (f"{out['ctas']} CTAs x {out['threads']} threads, "
               f"{out['lanes_per_thread']} lane(s) a thread, "
               f"{out['max_active_clusters']} such clusters fit the card"
               if query else "not reported")
    print(f"  {tag:30s} semi_decode cluster: {cluster}; {ms:.3f} ms = "
          f"{out['us_per_wave']:.3f} us a wave; table passes' share "
          f"{out['boundary_share']}; device ms by kernel (torch.profiler): "
          f"{json.dumps(split)}")
    return out


def check_semi_kernels():
    """K13 at the frozen shape, then K11 -> K7 -> K3 -> K12 at the
    adaptive shape with chunk 64, from a fresh table and from the table
    K13 trains on the same stream; each against its plain version on the
    same inputs on the card."""
    import torch
    from fastqueeze_tpu_torch.models.base import QualModel, SeqModel
    from fastqueeze_tpu_torch.ops import engine, kernels
    from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED + 7)
    rows = {}
    seq = SeqModel(alphabet=4, init=3, inc=1, cap=253, order=10)

    R = (T_MAIN * 7 // 8 // READ_LEN) * L_MAIN
    counts = np.full(R, READ_LEN, np.int64)
    lay = make_layout(counts, L_MAIN)
    g = torch.from_numpy(to_grid(lay, rng.integers(
        0, 4, R * READ_LEN).astype(np.uint8))).to(dev)
    cg = torch.from_numpy(engine._counts_grid(counts, L_MAIN)).to(dev)
    k13 = kernels.train_counts(g, cg, seq)
    p13 = kernels.train_counts_plain(g, cg, seq)
    valid, aux = kernels.device_aux_plain(T_MAIN, cg)
    flat = (seq.context_grids(g, aux).long() * 4 + g.long())[valid]

    def hist():
        return torch.bincount(flat, minlength=seq.n_ctx * 4)

    raw = hist().reshape(-1, 4) * seq.inc + seq.init
    under = raw.sum(dim=1) <= seq.cap        # rows the rescale leaves alone
    if not torch.equal(raw[under], k13[under].long()):
        raise AssertionError("torch.bincount's histogram != K13's")
    rows["train_seq_order10"] = {"train_counts": (
        _max_err(k13, p13), _time_ms(lambda: kernels.train_counts(g, cg, seq),
                                     5),
        _time_ms(lambda: kernels.train_counts_plain(g, cg, seq), 1))}
    BOUNDS["train_counts"] = (_nbytes(g, cg, k13),
                              _OPS["train_counts"] * R * READ_LEN
                              + 3 * k13.numel(), _time_ms(hist, 5))
    print(f"  train_seq_order10 (L = {L_MAIN}, T = {T_MAIN}, "
          f"{R * READ_LEN} symbols): bincount {BOUNDS['train_counts'][2]:.3f}"
          f" ms")
    # K13's halves (the mesh trainer's): the histogram into a zeroed table,
    # then the rows in place; together == K13, each == its plain version
    hk = torch.zeros_like(k13)
    kernels.train_hist(g, cg, seq, hk)
    hp = kernels.train_hist_plain(g, cg, seq, torch.zeros_like(k13))
    rk = kernels.train_rows(hk.clone(), seq)
    rp = kernels.train_rows_plain(hk.clone(), seq)
    if not torch.equal(rk, k13):
        raise AssertionError("train_hist + train_rows != K13")
    print("  train_hist + train_rows == train_counts (K13)")
    if not torch.equal(rk, rp):
        raise AssertionError("train_rows != its plain version")
    work = torch.empty_like(k13)
    # (the row pass's times, without the copy that restores its input:
    # check_row_pass)
    rows["train_split_seq_order10"] = {
        "train_hist": (_max_err(hk, hp), _time_ms(
            lambda: kernels.train_hist(g, cg, seq, work.zero_()), 5),
            _time_ms(lambda: kernels.train_hist_plain(
                g, cg, seq, work.zero_()), 1))}
    BOUNDS["train_hist"] = (_nbytes(g, cg, hk),
                            _OPS["train_counts"] * R * READ_LEN,
                            BOUNDS["train_counts"][2])
    PAIR_MS["train_hist_qual"] = _train_qual(R, lay, cg)
    del g, cg, flat, valid, aux, hk, hp, rk, rp, work

    reads = np.full(R_ADAPT, READ_LEN, np.int64)
    lay = make_layout(reads, L_ADAPT)
    assert (lay.T, lay.L) == (T_ADAPT, L_ADAPT), (lay.T, lay.L)
    n = R_ADAPT * READ_LEN
    cg = torch.from_numpy(engine._counts_grid(reads, L_ADAPT)).to(dev)
    for tag, m in (("semi_seq_order10", seq),
                   ("semi_qual_fqz_A40_q2", QualModel(
                       alphabet=40, init=1, inc=8, cap=8192, qlevel=2))):
        if m.alphabet == 40:     # drifting ranks: realistic fqz contexts
            syms = np.clip(np.cumsum(rng.integers(-2, 3, n)) % 60, 0, 39)
        else:
            syms = rng.integers(0, 4, n)
        g = torch.from_numpy(to_grid(lay, syms.astype(np.uint8))).to(dev)
        nh = engine._n_halve_chunk(m, L_ADAPT, SEMI_CHUNK)
        trained = kernels.train_counts(g, cg, m)
        for start, c0 in (("fresh", None), ("trained", trained)):
            r = {}

            def enc():
                return kernels.semi_encode_walk(g, cg, m, nh, SEMI_CHUNK, c0)

            def enc_plain():
                return kernels.semi_encode_walk_plain(g, cg, m, nh,
                                                      SEMI_CHUNK, c0)

            k11, (p11, p11_ms) = enc(), _timed(enc_plain)
            r["semi_encode_walk"] = (
                max(_max_err(a, b) for a, b in zip(k11, p11)),
                _time_ms(enc, 3), p11_ms)
            K11_SPLIT[f"{tag}_{start}"] = _split_row(
                f"{tag}_{start}", r["semi_encode_walk"][1], enc)
            sf, cnt = k11
            k7 = kernels.rans_encode_sf(sf, cg)
            out, nw = kernels.compact_words(*k7[:2])
            k = int(nw.item())
            wpad = _wpad(out, k)

            def dec():
                return kernels.semi_decode(k7[2], wpad, cg, T_ADAPT, m, nh,
                                           SEMI_CHUNK, c0)

            def dec_plain():
                return kernels.semi_decode_plain(k7[2], wpad, cg, T_ADAPT, m,
                                                 nh, SEMI_CHUNK, c0)

            k12, (p12, p12_ms) = dec(), _timed(dec_plain)
            r["semi_decode"] = (
                max(_max_err(a, b) for a, b in zip(k12, p12)),
                _time_ms(dec, 2), p12_ms)
            SEMI_SHAPE[f"{tag}_{start}"] = _semi_shape(
                f"{tag}_{start}", m, r["semi_decode"][1], dec)
            if not torch.equal(k12[0], g) or not torch.equal(k12[1], cnt):
                raise AssertionError(f"{tag} {start}: semi decode does not "
                                     f"invert encode")
            if tag == "semi_seq_order10" and start == "fresh":
                BOUNDS.update({
                    "semi_encode_walk": (_nbytes(g, cg, *k11),
                                         _OPS["semi_encode_walk"] * n, None),
                    "semi_decode": (_nbytes(k7[2], cg, *k12) + 2 * k,
                                    _OPS["semi_decode"] * n, None)})
            print(f"  {tag} from {start} (chunk {SEMI_CHUNK}, {k} words)")
            for name, (err, ms, pms) in r.items():
                print(f"  {tag + '_' + start:30s} {name:17s} max_abs_err "
                      f"{err}  kernel {ms:10.3f} ms  plain {pms:10.3f} ms")
                if err:
                    raise AssertionError(f"{tag} {start} {name}: kernel "
                                         f"differs from its plain version "
                                         f"({err})")
            rows[f"{tag}_{start}"] = r
    for name, (err, ms, pms) in dict(
            rows["train_seq_order10"],
            **rows["train_split_seq_order10"]).items():
        print(f"  {'train_seq_order10':30s} {name:17s} max_abs_err {err}  "
              f"kernel {ms:10.3f} ms  plain {pms:10.3f} ms")
        if err:
            raise AssertionError(f"train_counts: kernel differs from its "
                                 f"plain version ({err})")
    return rows


# The row pass (K13's row half; B15's train_rows, and its summing form
# train_rows_sum): by table, its device time alone (torch.profiler; the
# copy that restores its in-place input is a kernel of its own, left out),
# CUDA-event times with no copy in the window, and the summing form at
# ROW_NB partials; and phase 17's B15 call on the card by device work.
ROWS = {}
ROW_NB = (2, 4)
ROW_KERNELS = ("train_rows", "rows_finalize")   # the parent's, this tree's
B15_MESHES = ((2, 2), (4, 1), (1, 4))        # (block, ctx) shard counts
B15_SPLIT = {}


def _row_models() -> dict:
    """The tables the row pass finalizes at phase 3's shapes: the order-10
    seq table (2^20 x 4), the --qlevel 3 qual table (2^20 x 41) and the
    hashed rank chain (2^19 x 48)."""
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.models.base import (QualModel, SeqModel,
                                                  qual_model_for)
    return {"seq_order10": SeqModel(alphabet=4, init=3, inc=1, cap=253,
                                    order=10),
            "qual_q3_A41": qual_model_for(CodecParams(qlevel=3), 41),
            "qual_k4_hash16_pos3": QualModel(alphabet=48, k=4, ctx_base=40,
                                             hash_bits=16, pos_bits=3)}


def _edge_rows(m) -> np.ndarray:
    """Raw rows the row pass must get right: zeros; a row whose total after
    init is cap; one over cap; one that needs all 24 halvings (its total
    after init over cap x 2^23; an entry stays under 2^31)."""
    A = m.alphabet
    at = np.zeros(A, np.int64)
    at[0] = m.cap - A * m.init
    deep = np.full(A, -(-(m.cap << 23) // A) + 1 - m.init, np.int64)
    rows = np.stack([np.zeros(A, np.int64), at, at + np.eye(A)[0], deep])
    assert rows.max() < (1 << 31) - 2 - m.init, rows.max()
    return rows.astype(np.int32)


def _edge_at(n: int) -> list:
    """Where the edge rows go: the table's first and last four rows."""
    return [0, 1, 2, 3, n - 4, n - 3, n - 2, n - 1]


def _row_tables(dev):
    """(tag, model, raw table) for each of _row_models: K13's histogram
    half of a phase-3 stream (R_MAIN x 100 uniform symbols, L_MAIN lanes)
    with the edge rows planted at _edge_at."""
    import torch
    from fastqueeze_tpu_torch.ops import engine, kernels
    from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid
    rng = np.random.default_rng(SEED + 18)
    counts = np.full(R_MAIN, READ_LEN, np.int64)
    lay = make_layout(counts, L_MAIN)
    cg = torch.from_numpy(engine._counts_grid(counts, L_MAIN)).to(dev)
    for tag, m in _row_models().items():
        g = torch.from_numpy(to_grid(lay, rng.integers(
            0, m.alphabet, R_MAIN * READ_LEN).astype(np.uint8))).to(dev)
        h = torch.zeros((m.n_ctx, m.alphabet), dtype=torch.int32,
                        device=dev)
        kernels.train_hist(g, cg, m, h)
        h[_edge_at(m.n_ctx)] = torch.from_numpy(
            np.tile(_edge_rows(m), (2, 1))).to(dev)
        yield tag, m, h


def _row_device_ms(split: dict) -> float:
    return sum(v for k, v in split.items() if k in ROW_KERNELS)


def _time_each(fn, srcs) -> float:
    """Mean CUDA-event ms of fn(x) over the tensors ``srcs``, made before
    the window (an in-place kernel on a fresh copy each call, and no copy
    timed)."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for x in srcs:
        fn(x)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / len(srcs)


def check_row_pass(rows=None) -> dict:
    """The row pass on each _row_tables table: train_rows in place and,
    where the tree has it, train_rows_sum over ROW_NB partials (the raw
    table and rolled copies of it, the copies' edge rows zeroed) against
    their plain versions on the card, with the edge rows' results printed;
    CUDA-event ms (no copy in the window) and device ms by kernel
    (torch.profiler over 3 calls); bounds by bytes: (nb + 1) x the
    table.  Fills ROWS and, given ``rows``, the kernel table's rows."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    dev = torch.device("cuda", torch.cuda.current_device())
    summing = getattr(kernels, "train_rows_sum", None)
    for tag, m, h in _row_tables(dev):
        nbytes = _nbytes(h)
        got = kernels.train_rows(h.clone(), m)
        want, pms = _timed(lambda: kernels.train_rows_plain(h.clone(), m))
        err = _max_err(got, want)
        at = _edge_at(m.n_ctx)
        edges = {"raw": h[at[:4]].tolist(), "kernel": got[at[:4]].tolist()}
        works = [h.clone() for _ in range(5)]
        ms = _time_each(lambda x: kernels.train_rows(x, m), works)
        work = torch.empty_like(h)
        split = _device_split(
            lambda: kernels.train_rows(work.copy_(h), m), reps=3)
        r = {"shape": list(h.shape), "max_abs_err": err, "ms": ms,
             "plain_ms": pms, "device_ms": _row_device_ms(split),
             "device_ms_by_kernel": split,
             "bound_ms": 2 * nbytes / HBM_BPS * 1e3, "edge_rows": edges}
        print(f"  {tag:24s} train_rows {tuple(h.shape)}: max_abs_err {err}"
              f", {ms:.4f} ms (events, no copy), device {r['device_ms']:.4f}"
              f" ms, plain {pms:.3f} ms, bound {r['bound_ms']:.4f} ms; "
              f"device ms by kernel {json.dumps(split)}; edge rows after "
              f"the pass {edges['kernel']}")
        if err:
            raise AssertionError(f"train_rows {tag}: kernel differs from "
                                 f"its plain version ({err})")
        del works
        if summing is not None:
            r["sum"] = {}
            for nb in ROW_NB:
                parts = [h] + [torch.roll(h, 7919 * k, 0) for k in
                               range(1, nb)]
                for p in parts[1:]:
                    p[at] = 0
                got = summing(parts, m)
                want, spms = _timed(
                    lambda: kernels.train_rows_sum_plain(parts, m))
                serr = _max_err(got, want)
                if not torch.equal(got[at], want[at]) or serr:
                    raise AssertionError(f"train_rows_sum {tag} nb {nb}: "
                                         f"kernel differs from its plain "
                                         f"version ({serr})")
                sms = _time_ms(lambda: summing(parts, m), 5)
                ssplit = _device_split(lambda: summing(parts, m), reps=3)
                s = {"max_abs_err": serr, "ms": sms, "plain_ms": spms,
                     "device_ms": _row_device_ms(ssplit),
                     "device_ms_by_kernel": ssplit,
                     "bound_ms": (nb + 1) * nbytes / HBM_BPS * 1e3}
                r["sum"][f"nb{nb}"] = s
                print(f"  {tag:24s} train_rows_sum nb {nb}: max_abs_err "
                      f"{serr}, {sms:.4f} ms (events), device "
                      f"{s['device_ms']:.4f} ms, plain {spms:.3f} ms, bound "
                      f"{s['bound_ms']:.4f} ms")
        ROWS[tag] = r
        if rows is not None and tag == "seq_order10":
            rows["rows_seq_order10"] = {"train_rows": (err, ms, pms)}
            BOUNDS["train_rows"] = (2 * nbytes, 0, None)
            if summing is not None:
                s = r["sum"][f"nb{ROW_NB[0]}"]
                rows["rows_seq_order10"]["train_rows_sum"] = (
                    s["max_abs_err"], s["ms"], s["plain_ms"])
                BOUNDS["train_rows_sum"] = ((ROW_NB[0] + 1) * nbytes, 0,
                                            None)
    return ROWS


def _chrome_events(path: str) -> list:
    with open(path) as fh:
        tr = json.load(fh)
    return tr["traceEvents"] if isinstance(tr, dict) else tr


def _device_records(evs) -> list:
    """(start us, end us, name, category) of each kernel, copy and memset
    record of a Chrome trace's events."""
    return [(e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""),
             e.get("cat", "")) for e in evs
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and e.get("ph") == "X"]


def _trace_device(prof):
    """A torch.profiler session's device records (_device_records) and
    all its events, from its Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        evs = _chrome_events(path)
    finally:
        os.remove(path)
    return _device_records(evs), evs


def _busy_ms(ivs, lo: float, hi: float) -> float:
    """The union of the intervals (us) clipped to [lo, hi), in ms."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in ivs
                       if b > lo and a < hi):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _b15_kind(name: str, cat: str) -> str:
    if cat == "gpu_memcpy":
        return "copies"
    if cat == "gpu_memset" or "Fill" in name:
        return "fills"
    if any(k in name for k in ("chunk_", "drops_scan")):
        return "histogram"
    if any(k in name for k in ROW_KERNELS):
        return "rows"
    if "add" in name.lower():
        return "adds"
    return "other"


def _b15_inputs():
    """Phase 17's B15 (and B19) inputs: the model, 4 blocks of (1024,
    1024) uniform qualities (A = 40, qlevel 2), their 16-base reads'
    length grid, and the generator they came from."""
    from fastqueeze_tpu_torch.models.base import QualModel
    m = QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=2)
    Bk, Tk, Lk = MESH_SHARDS, 1024, 1024
    rng = np.random.default_rng(SEED + 17)
    syms = rng.integers(0, 40, (Bk, Tk, Lk)).astype(np.uint8)
    cgrid = np.full((Bk, Tk // 16, Lk), 16, np.int32)
    return m, syms, cgrid, rng


def b15_split(reps: int = 3) -> dict:
    """B15 (train_counts_sharded) on MESH_SHARDS shards sharing the card
    (visible_devices patched) for each B15_MESHES shape: its launches, the
    call's host-clock ms (ending in a synchronize), and the device time of
    one call by kind (histogram kernels, fills, copies, the row pass, the
    adds of a reduce, other) beside its idle ms (the call's window less
    the union of its device records), over ``reps`` calls traced by
    torch.profiler; each call == K13 on the stacked blocks."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from fastqueeze_tpu_torch.ops import kernels
    from fastqueeze_tpu_torch.parallel import mesh as tm
    dev = torch.device("cuda", torch.cuda.current_device())
    m, syms, cgrid, _ = _b15_inputs()
    Bk, Tk, Lk = syms.shape
    single = kernels.train_counts(
        torch.from_numpy(syms.reshape(Bk * Tk, Lk)).to(dev),
        torch.from_numpy(cgrid.reshape(-1, Lk)).to(dev), m)
    real = tm.visible_devices
    tm.visible_devices = lambda kind="cuda": [dev] * MESH_SHARDS
    try:
        for nb, nc in B15_MESHES:
            mesh = tm.make_mesh(MESH_SHARDS, ctx_shards=nc)

            def run():
                out = tm.train_counts_sharded(mesh, m, syms, cgrid)
                torch.cuda.synchronize()
                return out

            if not torch.equal(torch.cat(run()), single):
                raise AssertionError(f"B15 ({nb}, {nc}) != K13")
            kernels.reset_launch_counts()
            run()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            wall = (time.perf_counter() - t0) * 1e3 / reps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(reps):
                    with record_function(f"b15_call_{i}"):
                        run()
            dev_evs, evs = _trace_device(prof)
            wins = [(e["ts"], e["ts"] + e["dur"]) for e in evs
                    if e.get("name", "").startswith("b15_call_")
                    and e.get("cat") == "user_annotation"]
            by, window, busy = {}, 0.0, 0.0
            for lo, hi in wins:
                inside = [d for d in dev_evs if d[0] >= lo and d[1] <= hi]
                for a, b, name, cat in inside:
                    k = _b15_kind(name, cat)
                    by[k] = by.get(k, 0.0) + (b - a) / 1e3 / len(wins)
                window += (hi - lo) / 1e3 / len(wins)
                busy += _busy_ms([(a, b) for a, b, _, _ in inside],
                                 lo, hi) / len(wins)
            row = {"launches": launches, "call_ms": wall,
                   "traced_call_ms": window, "device_ms_by_kind": by,
                   "busy_ms": busy, "idle_ms": window - busy,
                   "traced_calls": len(wins)}
            B15_SPLIT[f"{nb}x{nc}"] = row
            print(f"  B15 on a ({nb}, {nc}) mesh: {wall:.3f} ms a call "
                  f"(host clock); traced {window:.3f} ms: device ms by kind"
                  f" {json.dumps(by)}, busy {busy:.3f}, idle "
                  f"{window - busy:.3f}; launches {json.dumps(launches)}")
    finally:
        tm.visible_devices = real
    return B15_SPLIT


def rows_main() -> int:
    """--rows: phases 1-2, then the row pass (check_row_pass) on phase 3's
    three tables and B15's call by device work on each B15_MESHES mesh
    (b15_split); no other kernel and no end-to-end phase.  It runs from
    an older tree's copy too (copy this file into it), so two trees' row
    passes compare in turns in one call, each in a fresh process."""
    card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    build()
    check_row_pass()
    b15_split()
    print(json.dumps({"rows": ROWS, "b15": B15_SPLIT}))
    _ok_line()
    return 0


# --nll: the frozen trainer's card scorer (K20, narrow_rows, K13's row
# half with inc) at a default compress's shapes, and _select_qctx with
# each scorer
NLL = {}


def _nll_sample(rng):
    """(rank symbols, read lengths) of R_MAIN reads of Markov qualities:
    the sample the card scorer uploads."""
    q = _markov_quals(rng, R_MAIN).reshape(-1) - 35
    return q.astype(np.uint8), np.full(R_MAIN, READ_LEN, np.int64)


def _nll_bytes(counts, hist, n_terms: int) -> int:
    """K20's bound, the function's least traffic: the table and the
    histogram read once, 8 B a term written (the kernel reads the row
    totals and the table's counts at the nonzero cells again over it)."""
    return _nbytes(counts, hist) + 8 * n_terms


def _check_nll_one(tag: str, counts, hist, mbits: int) -> dict:
    """K20 on (counts, hist) on the card against its plain version on
    the CPU (terms and stat bit-equal; np.sum of the terms ==
    frozen._hist_nll_bits), CUDA-event and device ms and its bound."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    from fastqueeze_tpu_torch.pipeline import frozen
    hc = hist.cpu()
    n_terms = int((hc > 0).sum())
    tab = frozen._log2_table(8192 * 64, counts.device)
    got, gstat = kernels.hist_nll(counts, hist, tab, mbits, n_terms)
    want, wstat = kernels.hist_nll(counts.cpu(), hc, tab.cpu(), mbits,
                                   n_terms)
    n = int(wstat[0])
    if not (torch.equal(gstat.cpu(), wstat)
            and torch.equal(got[:n].cpu(), want[:n])):
        raise AssertionError(f"hist_nll {tag}: kernel differs from its "
                             f"plain version")
    host = frozen._host_table(counts)
    if mbits:
        host = frozen._mant_bucket(host, mbits).astype(host.dtype)
    cost = float(np.sum(got[:n].cpu().numpy()))
    if cost != frozen._hist_nll_bits(host, hc.numpy()):
        raise AssertionError(f"hist_nll {tag}: cost differs from "
                             f"_hist_nll_bits")
    ms = _time_each(lambda _: kernels.hist_nll(counts, hist, tab, mbits,
                                               n_terms), range(5))
    plain_ms = _time_ms(lambda: kernels.hist_nll_plain(
        counts, hist, tab, mbits, n_terms), 1)
    split = _device_split(lambda: kernels.hist_nll(counts, hist, tab,
                                                   mbits, n_terms), reps=3)
    dev_ms = sum(v for k, v in split.items()
                 if k in ("nll_rows", "nll_tile"))
    bound = _nll_bytes(counts, hist, n) / HBM_BPS * 1e3
    r = {"shape": list(hist.shape), "mbits": mbits, "terms": n,
         "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
         "device_ms_by_kernel": split, "bound_ms": bound,
         "bytes": _nll_bytes(counts, hist, n)}
    print(f"  {tag:28s} hist_nll {tuple(hist.shape)} mbits {mbits}: "
          f"{n} terms, == plain and _hist_nll_bits; {ms:.4f} ms (events), "
          f"device {dev_ms:.4f} ms, bound {bound:.4f} ms; "
          f"{json.dumps(split)}")
    return r


def check_nll() -> dict:
    """The card scorer's kernels at _nll_sample's shapes (see --nll in
    the module docstring); fills NLL and BOUNDS (hist_nll: the seq
    table's, the largest; narrow_rows: the hashed chain's) and returns
    the kernels table's rows: {tag: {kernel: (max_abs_err, ms,
    plain_ms)}}."""
    import dataclasses
    import time
    import torch
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.models.base import QualModel, SeqModel
    from fastqueeze_tpu_torch.ops import kernels
    from fastqueeze_tpu_torch.pipeline import frozen
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED + 24)
    qs, lens = _nll_sample(rng)
    A = 40
    sc = frozen._CardScorer(CodecParams(), QualModel(alphabet=A),
                            np.zeros((1, A), np.int32), lambda: qs, lens,
                            True, 2.0, 2.0 * qs.size, dev)
    models = {
        "fqz_q2_A40": QualModel(alphabet=A, init=1, inc=16, qlevel=2),
        "chain_k3_A40": QualModel(alphabet=A, init=1, inc=16, qlevel=2, k=3,
                                  ctx_base=40),
        "hash_k4_18_A40": QualModel(alphabet=A, init=1, inc=16, qlevel=2,
                                    k=4, ctx_base=40, hash_bits=18)}
    table = {}
    for tag, m in models.items():
        hists = sc.scheme(m)
        t = kernels.train_rows_sum([hists.train], m, m.inc)
        want = kernels.train_rows_sum([hists.train.cpu()], m, m.inc)
        if not torch.equal(t.cpu(), want):
            raise AssertionError(f"train_rows_sum inc {tag}")
        if not np.array_equal(want.numpy(), frozen._cap_rescale(
                m, hists.train.cpu().numpy().copy())):
            raise AssertionError(f"train_rows_sum inc {tag} != _cap_rescale")
        rows_ms = _time_each(lambda _: kernels.train_rows_sum(
            [hists.train], m, m.inc), range(5))
        tn = kernels.narrow_rows(t, 2)
        if not torch.equal(tn.cpu(), kernels.narrow_rows(t.cpu(), 2)):
            raise AssertionError(f"narrow_rows {tag}")
        nar_ms = _time_each(lambda _: kernels.narrow_rows(t, 2), range(5))
        nar_plain_ms = _time_ms(lambda: kernels.narrow_rows_plain(t, 2), 1)
        r = _check_nll_one(tag, tn, hists.eval, 0)
        r["rows_inc_ms"] = rows_ms
        r["rows_bound_ms"] = 2 * _nbytes(t) / HBM_BPS * 1e3
        r["narrow_ms"] = nar_ms
        r["narrow_plain_ms"] = nar_plain_ms
        r["narrow_bound_ms"] = _nbytes(t, tn) / HBM_BPS * 1e3
        table[f"nll_{tag}"] = {
            "hist_nll": (0, r["ms"], r["plain_ms"]),
            "narrow_rows": (0, nar_ms, nar_plain_ms)}
        BOUNDS["narrow_rows"] = (_nbytes(t, tn), 0, None)
        t0 = time.perf_counter()
        cost, _ = sc.score(m, hists)
        r["score_s"] = time.perf_counter() - t0
        print(f"  {tag:28s} row pass with inc {rows_ms:.4f} ms (bound "
              f"{r['rows_bound_ms']:.4f}), narrow_rows {nar_ms:.4f} ms "
              f"(bound {r['narrow_bound_ms']:.4f}); the whole score "
              f"{r['score_s']:.3f} s (bz2-9 pricing on the host in it)")
        NLL[tag] = r
    seq = SeqModel(alphabet=4, init=3, inc=1, cap=253, order=10)
    shist = rng.integers(0, 60, (seq.n_ctx, 4)).astype(np.int32)
    counts = frozen._narrow_np(frozen._cap_rescale(seq, shist), seq.cap)
    st = torch.from_numpy(counts).to(dev)
    sh = torch.from_numpy(shist).to(dev)
    for mbits in (0, 3, 2):
        tag = f"seq_order10_m{mbits}"
        r = NLL[tag] = _check_nll_one(tag, st, sh, mbits)
        table[f"nll_{tag}"] = {"hist_nll": (0, r["ms"], r["plain_ms"])}
    BOUNDS["hist_nll"] = (NLL["seq_order10_m0"]["bytes"], 0, None)
    # _select_qctx on this sample: the host scorer (the parent's path),
    # then the card scorer
    from fastqueeze_tpu_torch.io import native
    from fastqueeze_tpu_torch.utils.metrics import DebugInfo
    qraw = (qs + 33).astype(np.uint8)
    lut = np.full(256, 255, np.uint8)
    lut[33:33 + A] = np.arange(A, dtype=np.uint8)
    qm = QualModel(alphabet=A, qlevel=2)
    qhist = native.qual_hist(qs, lens, 2, qm.drop_init, A)
    sel = {}
    for name, device in (("host", "cpu"), ("card", dev)):
        p = CodecParams()
        dbg = DebugInfo()
        t0 = time.perf_counter()
        with dbg.span("train.qctx"):
            counts, _, _ = frozen._select_qctx(
                p, dataclasses.replace(qm, init=p.qual_init,
                                       inc=p.qual_inc, cap=p.qual_cap),
                qhist, lambda: qs, lens, 2 * qs.size, A,
                native_args=(qraw, lens, 1, lut), device=device)
        sel[name] = {"s": time.perf_counter() - t0,
                     "price_s": dbg.vals["train.qctx.price_s"],
                     "scores": dbg.vals.get(f"qctx_{name}_scores"),
                     "qctx": [getattr(p, f) for f in frozen._QCTX_FIELDS],
                     "table": counts}
        print(f"  _select_qctx, {name} scorer: {sel[name]['s']:.3f} s, "
              f"bz2-9 pricing {sel[name]['price_s']:.3f} s, "
              f"{sel[name]['scores']} scores, qctx {sel[name]['qctx']}")
    if (sel["host"]["qctx"] != sel["card"]["qctx"]
            or not np.array_equal(sel["host"]["table"],
                                  sel["card"]["table"])):
        raise AssertionError("_select_qctx: the scorers chose differently")
    NLL["select_qctx"] = {k: {kk: vv for kk, vv in v.items()
                              if kk != "table"} for k, v in sel.items()}
    return table


def nll_main() -> int:
    """--nll: phases 1-2, then check_nll; no other kernel and no
    end-to-end phase."""
    card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    build()
    check_nll()
    print(json.dumps({"nll": NLL}))
    _ok_line()
    return 0


CTX_PLAIN_T = 512     # K18's plain version runs this many waves
CTX_GROUPS = 2        # K18's several-card route: groups of shards, one card
K18_SPLIT = {}        # K18's device ms by route and kernel (torch.profiler)


def _k18_stream(dev):
    """Phase 3's --qlevel 3 stream (L = 4096, T = 6144) on a 2^20 x 41
    table, encoded by K1 -> K2 -> K3: (model, states, padded words, read
    lengths, cum table, the symbols, words used)."""
    import torch
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.models.base import qual_model_for
    from fastqueeze_tpu_torch.ops import engine, kernels
    from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid
    m = qual_model_for(CodecParams(qlevel=3), 41)
    rng = np.random.default_rng(SEED + 9)
    counts = np.full(R_MAIN, READ_LEN, np.int64)
    lay = make_layout(counts, L_MAIN)
    g = torch.from_numpy(to_grid(lay, rng.integers(
        0, 41, R_MAIN * READ_LEN).astype(np.uint8))).to(dev)
    cg = torch.from_numpy(engine._counts_grid(counts, L_MAIN)).to(dev)
    table = torch.from_numpy(rng.integers(
        1, 400, (m.n_ctx, 41)).astype(np.int32)).to(dev)
    cum, packed = kernels.quant_pack(table)
    words, emit, states = kernels.frozen_encode_lanes(g, cg, packed, m)
    out, n = kernels.compact_words(words, emit)
    n = int(n.item())
    return m, states, _wpad(out, n), cg, cum, g, n


def _k18_steps(states, wpad, cg, T: int, cums, m):
    """K18's several-card route on one card: the shards in CTX_GROUPS
    groups (a ShardDecode each, as parallel/mesh.py makes a card's), one
    wave step a group at a time, each group's partial summed by
    mesh.psum between the steps -> (symbols, final states)."""
    from fastqueeze_tpu_torch.ops import kernels
    from fastqueeze_tpu_torch.parallel import mesh as tm
    per = len(cums) // CTX_GROUPS
    runs = [kernels.ShardDecode(states, wpad, cg, T,
                                cums[i * per:(i + 1) * per], m,
                                shard0=i * per, writer=i == 0)
            for i in range(CTX_GROUPS)]
    xin = [None] * CTX_GROUPS
    for t in range(T + 1):
        outs = [r.step(t, x) for r, x in zip(runs, xin)]
        if t < T:     # one (1, 3, L) partial a group (summed if it has more)
            xin = tm.psum([o if o.shape[0] == 1
                           else o.sum(0, dtype=o.dtype)[None]
                           for o in outs])
    return runs[0].out, runs[0].x


def _k18_split(tag: str, fn, waves: int) -> dict:
    """K18's (or K4's) device ms by kernel over one call of ``fn``
    (torch.profiler), and the kernels' device us a wave."""
    split = _device_split(fn)
    row = {"device_ms_by_kernel": split,
           "device_us_per_wave": sum(split.values()) * 1e3 / waves}
    print(f"  {tag:24s} device ms by kernel (torch.profiler): "
          f"{json.dumps(split)}; {row['device_us_per_wave']:.3f} us a wave")
    K18_SPLIT[tag] = row
    return row


def check_ctx_shard_kernel(split: bool = False):
    """K18 at the frozen shape (L = 4096, T = 6144) on a --qlevel 3 qual
    table (2^20 rows x 41, past CTX_SHARD_MIN_ENTRIES): a stream encoded
    by K1 -> K2 -> K3, decoded by K4 on the whole table and by K18 with
    the table cut into D = 2 and 4 row shards on the card (route (a): one
    launch a stream): bit-equal symbols, and every lane back at the
    encoder's initial state; then the several-card route (b) with the
    D = 4 shards in CTX_GROUPS groups, a launch a wave, == route (a) and
    K4; both against the plain version on the first CTX_PLAIN_T waves.
    With ``split`` each route's device time by kernel (torch.profiler)."""
    import torch
    from fastqueeze_tpu_torch.config import RANS_L
    from fastqueeze_tpu_torch.ops import kernels
    dev = torch.device("cuda", torch.cuda.current_device())
    m, states, wpad, cg, cum, g, n = _k18_stream(dev)
    k4 = kernels.frozen_decode(states, wpad, cg, T_MAIN, cum, m)
    if not torch.equal(k4, g):
        raise AssertionError("K4 does not invert the q3 stream")
    k4_ms = _time_ms(lambda: kernels.frozen_decode(states, wpad, cg, T_MAIN,
                                                   cum, m), 2)
    PAIR_MS["k4_q3"] = k4_ms
    print(f"  qual_q3 (2^20 x 41 table, {cum.numel()} entries): K4 "
          f"{k4_ms:.3f} ms on the whole table")
    K4_SHAPE["qual_q3"] = _k4_shape(m, k4_ms, "qual_q3")
    if split:
        _k18_split("k4_q3", lambda: kernels.frozen_decode(
            states, wpad, cg, T_MAIN, cum, m), T_MAIN)
    rows = {}
    for D in MESH_DS:
        nr = m.n_ctx // D
        # separate row blocks, as mesh.shard_tables makes them
        cums = [cum[i * nr:(i + 1) * nr].clone() for i in range(D)]
        kernels.reset_launch_counts()
        k18, x = kernels.ctx_shard_decode(states, wpad, cg, T_MAIN, cums, m)
        torch.cuda.synchronize()
        launches = kernels.LAUNCHES["ctx_shard_decode"]
        if not torch.equal(k18, k4):
            raise AssertionError(f"K18 D = {D} != K4 on the whole table")
        if not bool((x.long() & 0xFFFFFFFF == RANS_L).all()):
            raise AssertionError(f"K18 D = {D}: final states != RANS_L")
        kc, xc = kernels.ctx_shard_decode(states, wpad, cg, CTX_PLAIN_T,
                                          cums, m)
        (pc, px), pms = _timed(lambda: kernels.ctx_shard_decode_plain(
            states, wpad, cg, CTX_PLAIN_T, cums, m))
        err = max(_max_err(kc, pc), _max_err(xc, px))
        ms = _time_ms(lambda: kernels.ctx_shard_decode(
            states, wpad, cg, T_MAIN, cums, m), 2)
        print(f"  qual_q3_D{D}              ctx_shard_decode (a) == K4 (T = "
              f"{T_MAIN}, {launches} launch(es)), final states == RANS_L; "
              f"max_abs_err {err} vs the plain version at T = "
              f"{CTX_PLAIN_T}  kernel {ms:10.3f} ms  plain (T = "
              f"{CTX_PLAIN_T}) {pms:10.3f} ms  K4 {k4_ms:.3f} ms "
              f"({ms / k4_ms:.3f}x)")
        if err:
            raise AssertionError(f"ctx_shard_decode D = {D}: kernel differs "
                                 f"from its plain version ({err})")
        rows[f"qual_q3_D{D}"] = {"ctx_shard_decode": (err, ms, pms)}
        K18_SPLIT[f"a_D{D}"] = {"ms": ms, "launches": launches,
                                "vs_k4": ms / k4_ms}
        if split:
            _k18_split(f"route_a_D{D}", lambda: kernels.ctx_shard_decode(
                states, wpad, cg, T_MAIN, cums, m), T_MAIN)
    # route (b): the D = 4 shards of the last loop in CTX_GROUPS groups
    kernels.reset_launch_counts()
    (sb, xb), ms_b = _timed(lambda: _k18_steps(states, wpad, cg, T_MAIN,
                                               cums, m))
    launches_b = kernels.LAUNCHES["ctx_shard_decode"]
    if launches_b != CTX_GROUPS * (T_MAIN + 1):
        raise AssertionError(f"K18 route (b): {launches_b} launches, not a "
                             f"group and wave")
    if not (torch.equal(sb, k4) and torch.equal(xb, x)):
        raise AssertionError("K18 route (b) != route (a) / K4")
    kc, xc = _k18_steps(states, wpad, cg, CTX_PLAIN_T, cums, m)
    err_b = max(_max_err(kc, pc), _max_err(xc, px))
    if err_b:
        raise AssertionError(f"K18 route (b) differs from the plain version "
                             f"({err_b})")
    us = ms_b * 1e3 / (T_MAIN + 1)
    K18_SPLIT["b_D4"] = {"ms": ms_b, "groups": CTX_GROUPS,
                         "launches": launches_b, "us_per_wave": us}
    print(f"  qual_q3_D4_steps         ctx_shard_decode (b), {CTX_GROUPS} "
          f"groups, {launches_b} launches == route (a) and "
          f"K4; == the plain version at T = {CTX_PLAIN_T}: {ms_b:.3f} ms "
          f"(CUDA events, the partials' psum included) = {us:.3f} us a wave")
    if split:
        _k18_split("route_b_D4", lambda: _k18_steps(states, wpad, cg, T_MAIN,
                                                    cums, m), T_MAIN + 1)
    BOUNDS["ctx_shard_decode"] = (_nbytes(states, cg, cum, k4) + 2 * n,
                                  _OPS["frozen_decode"] * R_MAIN * READ_LEN,
                                  None)
    del g, cg, cum, cums
    return rows


L_WIDE = 8192        # --shards: K4 past 4096 lanes, several lanes a thread
K4_WIDE = {}         # its ms and device ms by table


def check_k4_wide() -> None:
    """--shards: K4 at L_WIDE lanes, where it runs several lanes a thread
    (csrc/frozen_wave.cuh decode_multi), on the order-10 seq table and
    the 2^20 x 41 --qlevel 3 qual table: R_MAIN x 100 bp random reads
    encoded by K1 -> K2 -> K3, decoded == the symbols; its ms (CUDA
    events) and device ms by kernel (torch.profiler)."""
    import torch
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.models.base import SeqModel, qual_model_for
    from fastqueeze_tpu_torch.ops import engine, kernels
    from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED + 11)
    counts = np.full(R_MAIN, READ_LEN, np.int64)
    lay = make_layout(counts, L_WIDE)
    cg = torch.from_numpy(engine._counts_grid(counts, L_WIDE)).to(dev)
    for tag, m in (("seq_order10", SeqModel(alphabet=4, init=3, inc=1,
                                            cap=253, order=10)),
                   ("qual_q3", qual_model_for(CodecParams(qlevel=3), 41))):
        g = torch.from_numpy(to_grid(lay, rng.integers(
            0, m.alphabet, R_MAIN * READ_LEN).astype(np.uint8))).to(dev)
        table = torch.from_numpy(rng.integers(
            1, 254 if m.alphabet == 4 else 400,
            (m.n_ctx, m.alphabet)).astype(np.int32)).to(dev)
        cum, packed = kernels.quant_pack(table)
        words, emit, states = kernels.frozen_encode_lanes(g, cg, packed, m)
        out, n = kernels.compact_words(words, emit)
        wpad = _wpad(out, int(n.item()))

        def run():
            return kernels.frozen_decode(states, wpad, cg, lay.T, cum, m)

        if not torch.equal(run(), g):
            raise AssertionError(f"K4 at L = {L_WIDE} ({tag}) does not "
                                 f"invert the stream")
        ms = _time_ms(run, 3)
        split = _device_split(run)
        K4_WIDE[tag] = {"L": L_WIDE, "T": lay.T, "ms": ms,
                        "device_ms_by_kernel": split}
        print(f"  {tag:22s} K4 at L = {L_WIDE}, T = {lay.T} == the "
              f"symbols: {ms:.3f} ms, device ms by kernel (torch.profiler)"
              f" {json.dumps(split)}")
        del g, table, cum, packed, words, emit, states, out, wpad


def _genome(G: int = GENOME_LEN) -> np.ndarray:
    """The seeded random genome every generated input samples."""
    return np.random.default_rng(SEED).integers(0, 4, G, dtype=np.uint8)


def _align_reads(rng, genome, n, kind):
    """n x 100 bp reads from ``genome`` as each aligner tier meets them
    (zero-padded (n, 128) code grid, degenerate flags, lengths):
    tier1 = ~1% substitutions, 30% reverse strand, 10% random reads;
    rescue = 4-9 substitutions a read (tier 1 misses most) and 10% random;
    indel = one or two 1-3 bp indels, some with substitutions."""
    G = len(genome)
    s = rng.integers(0, G - 200, n)
    i = np.arange(READ_LEN)[None, :]
    off = np.zeros((n, READ_LEN), np.int64)
    if kind == "indel":
        for _ in range(2):
            at = rng.integers(15, READ_LEN - 15, n)
            g = rng.integers(-3, 4, n) * (rng.random(n) < 0.8)
            off += np.where(i >= at[:, None], g[:, None], 0)
    codes = genome[np.clip(s[:, None] + i + off, 0, G - 1)]
    n_sub = {"tier1": 0, "rescue": 9, "indel": 2}[kind]
    if kind == "tier1":
        e = rng.random(codes.shape) < 0.01
        codes[e] = (codes[e] + 1) % 4
    else:
        r = np.repeat(np.arange(n), n_sub)
        c = rng.integers(0, READ_LEN, n * n_sub)
        codes[r, c] = (codes[r, c] + rng.integers(1, 4, len(r))) % 4
    junk = rng.random(n) < 0.1
    codes[junk] = rng.integers(0, 4, (int(junk.sum()), READ_LEN))
    rc = rng.random(n) < 0.3
    codes[rc] = 3 - codes[rc, ::-1]
    grid = np.zeros((n, ALIGN_LP), np.uint8)
    grid[:, :READ_LEN] = codes
    return grid, np.zeros((n, ALIGN_LP), bool), np.full(n, READ_LEN, np.int32)


def _window_reads(rng, genome, n, C, lp=ALIGN_LP, read_len=READ_LEN):
    """n mates of read_len bases for the PE rescue window, each with its
    window center (the mapped mate's position, within C/2 of the read):
    25% seedless (the 7 substitutions at SEEDLESS_AT), 60% with ~1%
    substitutions, 10% random, 5% whose true position lies outside the
    window; 30% reverse strand; zero-padded (n, lp) grid."""
    G = len(genome)
    s = rng.integers(C, G - C - 2 * read_len, n)
    codes = genome[s[:, None] + np.arange(read_len)]
    kind = rng.random(n)
    seedless = kind < 0.25
    codes[np.ix_(np.flatnonzero(seedless), SEEDLESS_AT)] = (
        codes[np.ix_(np.flatnonzero(seedless), SEEDLESS_AT)] + 1) % 4
    e = (rng.random(codes.shape) < 0.01) & ((kind >= 0.25)
                                            & (kind < 0.85))[:, None]
    codes[e] = (codes[e] + 1) % 4
    junk = (kind >= 0.85) & (kind < 0.95)
    codes[junk] = rng.integers(0, 4, (int(junk.sum()), read_len))
    rc = rng.random(n) < 0.3
    codes[rc] = 3 - codes[rc, ::-1]
    centers = s + rng.integers(-(C // 2) + 2, C // 2 - read_len, n)
    centers[kind >= 0.95] += C
    grid = np.zeros((n, lp), np.uint8)
    grid[:, :read_len] = codes
    return (grid, np.zeros((n, lp), bool),
            np.full(n, read_len, np.int32), centers.astype(np.int32))


# K10's shapes in phase 3: (Lp, read length): 100 bp mates (the smoke's
# reads) and 250 bp (2 x 250 runs) at Lp 256
WINDOW_LPS = ((ALIGN_LP, READ_LEN), (256, 250))


def _window_words(packed, ref_len, c, d, ln, ctr, C, out):
    """The frame words K10's scan needs on these inputs, whatever
    implements it: per strand, each candidate's words read until its
    partial count rules it out against the strand's first-occurrence
    best (a count at the best, or above it before the best's index),
    every word of the best itself; the reverse strand bounded by the
    forward best and skipped where that is 0; none for a read with a
    degenerate base.  Also the full scans' words (every valid candidate
    over all W + 1 words on the forward strand, and on the reverse unless
    the forward best is 0: the count earlier bounds used)."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    dev = c.device
    B, Lp = c.shape
    W = Lp // 16
    lens = ln.long()
    valid = torch.arange(Lp, device=dev)[None, :] < lens[:, None]
    dg = (d & valid).any(1)
    cj = torch.arange(C, device=dev)[None, :]
    cand = ctr.long()[:, None] - C // 2 + cj
    ok = (cand >= 0) & (cand + lens[:, None] <= ref_len) & ~dg[:, None]
    pk = packed.long() & 0xFFFFFFFF
    big = kernels.ALIGN_BIG

    def strand(codes, bound):
        rw, mw = kernels._pack_words(codes, valid)
        part = torch.zeros(cand.shape, dtype=torch.int64, device=dev)
        pre = []
        for j in range(W + 1):
            pre.append(part)
            part = part + kernels._mis_aligned(pk, cand & 0xFFFFFFFF, rw,
                                               mw, [j])
        tot = torch.where(ok, part, big)
        best, at = tot.min(1)
        thr = torch.minimum(best[:, None] + (cj < at[:, None]).long(),
                            bound[:, None])
        win = (cj == at[:, None]) & (best < bound)[:, None]
        n = sum((p < thr).long() for p in pre)
        n = torch.where(win, W + 1, n)
        return int(torch.where(ok, n, 0).sum()), best

    need_f, mis_f = strand(c.long(), torch.full((B,), big, device=dev))
    rc, _ = kernels._rc_grid(c, d, lens)
    need_r, _ = strand(rc, torch.where(mis_f > 0, mis_f, 0))
    zero_f = out[0] & ~out[2] & ~out[3].any(1)
    full = int((ok.sum(1) * torch.where(zero_f, 1, 2)).sum()) * (W + 1)
    return need_f + need_r, full


def _check_window_kernel(packed, ref_len, genome, rows) -> None:
    """K10 vs its plain version on the card: B = 4096 mates over the
    seeded genome's packed reference, C = 1128 (-I 500), at Lp 128
    (100 bp) and Lp 256 (250 bp); its time, device time (torch.profiler)
    and bound."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    dev = packed.device
    for lp, read_len in WINDOW_LPS:
        tag = "k14_window" if lp == ALIGN_LP else f"k14_window_lp{lp}"
        c, d, ln, ctr = (torch.from_numpy(a).to(dev) for a in _window_reads(
            np.random.default_rng(SEED + 6), genome, 4096, WINDOW_C, lp,
            read_len))

        def run():
            return kernels.window_batch(packed, ref_len, c, d, ln, ctr,
                                        WINDOW_C, 7)

        def plain():
            return kernels.window_batch_plain(packed, ref_len, c, d, ln,
                                              ctr, WINDOW_C, 7)

        got, want = run(), plain()
        torch.cuda.synchronize()
        m = want[0]
        err = int((got[0] != m).sum())
        for a, b in zip(got[1:], want[1:]):
            if a[m].numel():
                err = max(err, int((a[m].long() - b[m].long()).abs().max()))
        ms, pms = _time_ms(run, 5), _time_ms(plain, 1)
        print(f"  {tag} C={WINDOW_C} Lp={lp} window_batch B = {len(ln)}: "
              f"{int(m.sum())} mapped ({int(got[2][m].sum())} reverse), "
              f"max_abs_err {err}  kernel {ms:10.3f} ms  plain {pms:10.3f} "
              f"ms")
        if err:
            raise AssertionError(f"window_batch: kernel differs from its "
                                 f"plain version ({err})")
        rows[tag] = {"window_batch": (err, ms, pms)}
        K10_SPLIT[f"lp{lp}"] = _split_row(f"{tag}_window_batch", ms, run)
        # what the scan needs a frame word (_VERIFY_OPS) over the words
        # these inputs need; the window's reference words once a read
        need, full = _window_words(packed, ref_len, c, d, ln, ctr, WINDOW_C,
                                   got)
        win = min(len(ln) * ((WINDOW_C + lp) // 16 + 2) * 4,
                  _nbytes(packed))
        byts = _nbytes(c, d, ln, ctr, *got) + win
        key = "window_batch" if lp == ALIGN_LP else f"window_batch_lp{lp}"
        BOUNDS[key] = (byts, need * _VERIFY_OPS, None)
        K10_SPLIT[f"lp{lp}"].update(
            frame_words_needed=need, frame_words_full_scan=full,
            full_scan_bound_ms=max(byts / HBM_BPS,
                                   full * _VERIFY_OPS / INT_OPS) * 1e3,
            **_bound_row(key))
        print(f"  {tag}: frame words needed {need}, full scan {full}; "
              f"{_bound_row(key)}; full-scan bound "
              f"{K10_SPLIT[f'lp{lp}']['full_scan_bound_ms']:.4f} ms")
        del c, d, ln, ctr, got, want


def _indel_extra(G: int, Lp: int):
    """(operations, bytes) K9's scoring adds to a strand-read on top of
    the anchor search: the 2G+1 shifted compares and their prefix sums,
    the one-op split scan and the two-op scans; the window's words."""
    return ((2 * G + 1) * Lp * 6 + 4 * G * (Lp + 1) * 4
            + 4 * G * (Lp + 1) * 6, ((Lp + 2 * G) // 16 + 2) * 4)


def _fallback_bound(ix, cfg, c, d, ln, outs):
    """_align_bound of K8 with RC as the fallback: forward on every row
    of length > 0, RC on the rows forward leaves unmapped."""
    import dataclasses
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    fwd = kernels.align_batch(c, d, ln, ix,
                              dataclasses.replace(cfg, strand="fwd"))[0]
    rr = ((ln > 0) & ~fwd).nonzero()[:, 0]
    rc, rd = kernels._rc_grid(c, d, ln.long())
    rcr = rc[rr].to(torch.uint8)
    b_f = _align_bound(ix, cfg, c, d, ln, outs)
    b_r = _align_bound(ix, cfg, rcr, rd[rr], ln[rr], [])
    return b_f[0] + b_r[0] - _nbytes(rcr, rd[rr], ln[rr]), b_f[1] + b_r[1]


def _vs_plain(tag: str, name: str, run, plain, rows, reps: int, note=""):
    """An aligner kernel (K8, K9) against its plain version on the same
    inputs: equal on the first output (mapped / found) and on every other
    output of the rows it selects.  Returns the kernel's outputs."""
    import torch
    got, want = run(), plain()
    torch.cuda.synchronize()
    m = want[0]
    err = int((got[0] != m).sum())
    for a, b in zip(got[1:], want[1:]):
        if a[m].numel():
            err = max(err, int((a[m].long() - b[m].long()).abs().max()))
    ms, pms = _graph_ms(run, reps), _time_ms(plain, 1)
    print(f"  {tag:18s} {name:12s} B = {len(m)}{note}: {int(m.sum())} "
          f"mapped, max_abs_err {err}  kernel {ms:10.3f} ms  plain "
          f"{pms:10.3f} ms")
    if err:
        raise AssertionError(f"{name} {tag}: kernel differs from its plain "
                             f"version ({err})")
    rows[tag] = {name: (err, ms, pms)}
    return got


def _check_fused(ix, c, d, ln, k: int, G: int, ops: int, tag: str, rows,
                 tiers: bool = False) -> None:
    """K14 vs its plain version on one batch's (B, Lp) grids.  The todo
    list is the batch's tier-1 failures (K8, both strands, RC as the
    fallback), padded to a power of two >= 128.  Beside it, K8's rescue
    over the todo rows and K9 over the rows it left unmapped, launched
    separately (the classic chain's two tiers, less its host round trip).
    With ``tiers``, K8's tier 1, that rescue and that K9 are each held
    against their plain versions too, with their bounds."""
    import dataclasses
    import torch
    from fastqueeze_tpu_torch.align.hash import AlignConfig
    from fastqueeze_tpu_torch.ops import kernels
    dev = ix.packed.device
    Lp = c.shape[1]
    tier1 = AlignConfig(k=k, stride=2, n_cand=64, max_mis=7, both_strands=0,
                        lp=Lp, probe_k=16)
    deep = dataclasses.replace(tier1, n_cand=1024, n_seeds=6, excl_bp=7,
                               probe_k=1024)
    if tiers:
        g1 = _vs_plain(f"{tag}_tier1", "align_batch",
                       lambda: kernels.align_batch(c, d, ln, ix, tier1),
                       lambda: kernels.align_batch_plain(c, d, ln, ix, tier1),
                       rows, 5, f" Lp {Lp}")
        BOUNDS[f"{tag}_tier1"] = _fallback_bound(ix, tier1, c, d, ln,
                                                 g1) + (None,)
        m1 = g1[0].cpu().numpy()
    else:
        m1 = kernels.align_batch(c, d, ln, ix, tier1)[0].cpu().numpy()
    todo = np.flatnonzero(~m1 & (ln.cpu().numpy() >= k))
    cap = 128
    while cap < len(todo):
        cap <<= 1
    idx = np.zeros(cap, np.int32)
    idx[:len(todo)] = todo
    do = torch.from_numpy(np.arange(cap) < len(todo)).to(dev)
    idx = torch.from_numpy(idx).to(dev)
    args = (c, d, ln, idx, do, ix, deep, deep, G, ops)

    def run():
        return kernels.rescue_indel_fused(*args)

    def plain():
        return kernels.rescue_indel_fused_plain(*args)

    got, want = run(), plain()
    torch.cuda.synchronize()
    m2, f = want[0], want[4]
    err = int((got[0] != m2).sum()) + int((got[4] != f).sum())
    for sel, lo, hi in ((m2, 1, 4), (f, 5, 12)):
        for a, b in zip(got[lo:hi], want[lo:hi]):
            if a[sel].numel():
                err = max(err, int((a[sel].long() - b[sel].long()).abs()
                                   .max()))
    # the same rows through K8's rescue, then K9 over the rows it missed
    sel = idx.long()
    ct, dt, lt = c[sel], d[sel], torch.where(do, ln[sel], 0)
    bad = (do & ~got[0]).nonzero()[:, 0]
    cb, db, lb = ct[bad], dt[bad], lt[bad]

    def pair():
        kernels.align_batch(ct, dt, lt, ix, deep)
        if ops:
            kernels.indel_batch(cb, db, lb, ix, deep, G, ops)

    ms, pms, pair_ms = _graph_ms(run, 3), _time_ms(plain, 1), _graph_ms(pair, 3)
    print(f"  {tag:18s} {'rescue' if not ops else 'rescue+indel':12s} "
          f"rescue_indel_fused Lp {Lp} cap = {cap} ({len(todo)} tier-1 "
          f"failures of {len(ln)}): {int(m2.sum())} rescued, {int(f.sum())} "
          f"by indels, max_abs_err {err}  kernel {ms:10.3f} ms  plain "
          f"{pms:10.3f} ms;  K8 rescue + K9 separately {pair_ms:10.3f} ms")
    if err:
        raise AssertionError(f"rescue_indel_fused {tag}: kernel differs "
                             f"from its plain version ({err})")
    rows[tag] = {"rescue_indel_fused": (err, ms, pms)}
    PAIR_MS[tag] = pair_ms
    # bound: K8's rescue over the todo rows plus K9 over the rows the
    # rescue left (both strands, the scoring on top)
    b_r = _fallback_bound(ix, deep, ct, dt, lt, got[:4])
    b_i = (0, 0)
    if ops:
        xo, xb = _indel_extra(G, Lp)
        b_i = _align_bound(ix, deep, cb, db, lb, got[4:], strands=2,
                           extra_ops=xo, extra_bytes=xb)
    BOUNDS[tag] = (b_r[0] + b_i[0], b_r[1] + b_i[1], None)
    if tiers:
        if not len(bad) or not ops:
            raise AssertionError(f"{tag}: no row left for K9")
        _vs_plain(f"{tag}_rescue", "align_batch",
                  lambda: kernels.align_batch(ct, dt, lt, ix, deep),
                  lambda: kernels.align_batch_plain(ct, dt, lt, ix, deep),
                  rows, 3, f" Lp {Lp}")
        _vs_plain(f"{tag}_indel", "indel_batch",
                  lambda: kernels.indel_batch(cb, db, lb, ix, deep, G, ops),
                  lambda: kernels.indel_batch_plain(cb, db, lb, ix, deep, G,
                                                    ops),
                  rows, 3, f" Lp {Lp} G {G} ops {ops}")
        BOUNDS[f"{tag}_rescue"] = b_r + (None,)
        BOUNDS[f"{tag}_indel"] = b_i + (None,)


def _check_fused_kernel(ix, genome, k, rows) -> None:
    """K14 at Lp = 128 over the tier-1 failures of 4096 reads: tier-1
    reads (~1% substitutions; a seed with an error can list only a wrong
    locus) and the rescue only over the k = 14 index (the CLI defaults),
    indel reads and both halves (G = 3, two ops: -q) over the k = 22
    index."""
    import torch
    c, d, ln = (torch.from_numpy(a).to(ix.packed.device) for a in
                _align_reads(np.random.default_rng(SEED + 7 + k), genome,
                             4096, "tier1" if k == 14 else "indel"))
    G, ops = (0, 0) if k == 14 else (3, 2)
    _check_fused(ix, c, d, ln, k, G, ops, f"k{k}_fused", rows)


def _lr_chunks(genome, n: int = 4096):
    """The first n chunks of phase 14's long reads as the chunk tier grids
    them at the CLI defaults (align_max_len 2048, longread_chunk 1024,
    longread_tail_min 64): (n, 1024) codes, degenerate flags, lengths."""
    from fastqueeze_tpu_torch.align.hash import _gridify, lp_bucket
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.pipeline.blockcodec import _intra_of, _lr_grid
    p = CodecParams()
    reads = [r for r, _ in _long_reads(np.random.default_rng(SEED + 9),
                                       genome, 595)]
    lengths = np.array([len(r) for r in reads], np.int64)
    rd, offs, clens = _lr_grid(lengths, p.align_max_len,
                               min(p.longread_chunk, p.align_max_len),
                               p.longread_tail_min)
    if len(rd) < n:
        raise AssertionError(f"only {len(rd)} long-read chunks")
    rd, offs, clens = rd[:n], offs[:n], clens[:n]
    starts = np.cumsum(lengths) - lengths
    sym = np.repeat(starts[rd] + offs, clens) + _intra_of(clens)
    codes, dege = _gridify(np.concatenate(reads)[sym],
                           np.zeros(len(sym), bool), clens,
                           lp_bucket(int(clens.max())))
    return codes, dege, clens.astype(np.int32)


def _check_longread_kernels(ix, genome, rows) -> None:
    """K8, K14 and K9 at the chunk tier's shape: 4096 chunks of phase 14's
    long reads (one Aligner.BATCH), Lp = 1024, over the k = 14 index with
    the chunk tier's gap budget (G = 3, two ops): K8's tier 1 (both
    strands), K14 over its failures, and K8's rescue and K9 on K14's
    rows, each against its plain version."""
    import torch
    c, d, ln = (torch.from_numpy(a).to(ix.packed.device)
                for a in _lr_chunks(genome))
    _check_fused(ix, c, d, ln, 14, 3, 2, "lr1024", rows, tiers=True)


# --aligner: K8's rescue and tier 1 and K9 over batches of these sizes,
# ms a call, by kernel and batch (timed only; checked at phase 3's sizes)
SWEEP = {}


def _batch_sweep(ix, genome, k: int) -> None:
    """Times K8 (tier 1 forward and the rescue tier; k = 14) or K9
    (G = 3, two ops; k = 22) at several batch sizes, fresh reads a size."""
    import torch
    from fastqueeze_tpu_torch.align.hash import AlignConfig
    from fastqueeze_tpu_torch.ops import kernels
    base = dict(k=k, stride=2, n_cand=64, max_mis=7, both_strands=0,
                lp=ALIGN_LP)
    deep = AlignConfig(**dict(base, n_cand=1024, n_seeds=6, excl_bp=7))
    fwd = AlignConfig(**dict(base, strand="fwd", probe_k=16))
    cases = ([("k8_fwd", "tier1", fwd, (4096, 16384)),
              ("k8_rescue", "rescue", deep, (512, 1024, 2048, 4096))]
             if k == 14 else
             [("k9_G3_ops2", "indel", deep, (512, 1024, 2048, 4096))])
    rng = np.random.default_rng(SEED + 11)
    for name, kind, cfg, sizes in cases:
        for B in sizes:
            c, d, ln = (torch.from_numpy(a).to(ix.packed.device)
                        for a in _align_reads(rng, genome, B, kind))
            if name.startswith("k9"):
                run = lambda: kernels.indel_batch(c, d, ln, ix, cfg, 3, 2)
            else:
                run = lambda: kernels.align_batch(c, d, ln, ix, cfg)
            run()
            ms = _graph_ms(run, 3)
            SWEEP.setdefault(name, {})[B] = ms
            print(f"  sweep {name:12s} B = {B:5d}: {ms:9.3f} ms, "
                  f"{1e3 * ms / B:8.3f} us a read")


def check_align_kernels(genome, sweep: bool = False):
    """K8, K9, K10 and K14 vs their plain versions on the card, at the
    main path's shapes: the seeded 100 Mbp genome's index (k = 14 for K8
    and K10, k = 22 for K9, both for K14), B = 4096 tier-1 reads and
    B = 512 rescue / indel reads at Lp = 128, B = 4096 mates at C = 1128
    for K10, the tier-1 failures of a 4096-read batch for K14.  K8 and K10
    must equal on mapped and on the mapped reads' pos, strand and mask;
    K9 on found and on every output of the found reads; K14 on m2 and f
    and the outputs of the slots they select."""
    import torch
    from fastqueeze_tpu_torch.align.hash import AlignConfig, Aligner
    from fastqueeze_tpu_torch.align.index import build_from_ref
    from fastqueeze_tpu_torch.align.ref import RefSeq
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.ops import kernels
    dev = torch.device("cuda", torch.cuda.current_device())
    ref = RefSeq(genome, np.zeros(len(genome), bool), ["g"],
                 np.array([0, len(genome)]), "")
    rng = np.random.default_rng(SEED + 4)
    grids = {kind: tuple(torch.from_numpy(a).to(dev) for a in
                         _align_reads(rng, genome, n, kind))
             for kind, n in (("tier1", 4096), ("rescue", 512),
                             ("indel", 512))}
    rows = {}
    for k in (14, 22):
        t0 = time.time()
        p = CodecParams(seed_len=k)
        idx = build_from_ref(ref, p)
        al = Aligner(idx, p)
        ix = al.dev_index(dev)
        torch.cuda.synchronize()
        mb = sum(t.numel() * t.element_size() for t in ix[:5]) / 1e6
        print(f"  index k = {k}: {mb:.0f} MB on the card, built and "
              f"uploaded in {time.time() - t0:.1f} s")
        base = dict(k=k, stride=2, n_cand=64, max_mis=7, both_strands=0,
                    lp=ALIGN_LP)
        deep = dict(base, n_cand=1024, n_seeds=6, excl_bp=7)
        cases = ([("fwd", "tier1", dict(base, strand="fwd", probe_k=16)),
                  ("rc", "tier1", dict(base, strand="rc", probe_k=16)),
                  ("rescue", "rescue", deep)] if k == 14
                 else [("indel_G3_ops2", "indel", deep)])
        for tag, kind, kw in cases:
            cfg = AlignConfig(**kw)
            c, d, ln = grids[kind]
            if tag.startswith("indel"):
                name = "indel_batch"
                run = lambda: kernels.indel_batch(c, d, ln, ix, cfg, 3, 2)
                plain = lambda: kernels.indel_batch_plain(c, d, ln, ix, cfg,
                                                          3, 2)
            else:
                name = "align_batch"
                run = lambda: kernels.align_batch(c, d, ln, ix, cfg)
                plain = lambda: kernels.align_batch_plain(c, d, ln, ix, cfg)
            got = _vs_plain(f"k{k}_{tag}", name, run, plain, rows,
                            5 if kind == "tier1" else 3)
            if tag == "fwd":
                BOUNDS["align_batch"] = _align_bound(ix, cfg, c, d, ln,
                                                     got) + (None,)
            elif name == "indel_batch":
                xo, xb = _indel_extra(3, ALIGN_LP)
                BOUNDS["indel_batch"] = _align_bound(
                    ix, cfg, c, d, ln, got, strands=2, extra_ops=xo,
                    extra_bytes=xb) + (None,)
        if k == 14:
            _check_window_kernel(ix.packed, al.ref_len, genome, rows)
            _check_longread_kernels(ix, genome, rows)
            _check_sharded_kernel(idx, ix, grids["tier1"], rows)
        _check_fused_kernel(ix, genome, k, rows)
        if sweep:
            _batch_sweep(ix, genome, k)
        del al, ix, idx
    return rows


_K19 = ("sharded_lookup", "sharded_candidates", "sharded_verify",
        "sharded_tail")


K19_PHASES = ("lookup", "candidates", "verify", "tail")
K19_SPLIT = {}


def _k19_split(run, ms: float) -> None:
    """The index-sharded call's device ms by K19 phase (torch.profiler over
    3 calls), the rest of its device time (the collectives' and the
    wrappers' PyTorch kernels: fills, copies, min / max) and the idle
    share of the call's CUDA-event ms."""
    split = _device_split(run, reps=3)
    phases = {p: split.get(p, 0.0) for p in K19_PHASES}
    rest = {k: v for k, v in split.items() if k not in K19_PHASES}
    busy = sum(split.values())
    K19_SPLIT.update(call_ms=ms, device_ms_by_phase=phases,
                     k19_device_ms=sum(phases.values()),
                     other_device_ms=sum(rest.values()),
                     other_by_kernel=rest, idle_ms=ms - busy)
    print(f"  sharded_align device ms by phase (torch.profiler): "
          f"{json.dumps(phases)}; K19 {K19_SPLIT['k19_device_ms']:.4f}, "
          f"other kernels (collectives, fills, copies) "
          f"{K19_SPLIT['other_device_ms']:.4f}, idle {ms - busy:.4f} of "
          f"{ms:.4f} ms a call; other: {json.dumps(rest)}")


def _k19_launches(run) -> None:
    """The launches of one index-sharded call (the shards sharing the
    card, one device group: a launch a phase and strand, and the tail)."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    K19_SPLIT.update(launches=kernels.LAUNCHES["sharded_align"])
    print(f"  sharded_align launches a call: {K19_SPLIT['launches']}")


def _check_sharded_kernel(idx, ix, grid, rows) -> None:
    """K19 at B = 4096, Lp = 128 over the k = 14 index sharded D = 4
    (shards sharing the card): the index-sharded aligner's call
    (mesh.align_blocks_index_sharded at the ShardedAligner's settings:
    6 seeds, +-7 bp, 64 candidates a seed) against the same call with
    every phase's plain version, equal in mapped, pos, rev and mask;
    its time beside K8's tier 1."""
    import torch
    from fastqueeze_tpu_torch.align.hash import AlignConfig
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.ops import kernels
    from fastqueeze_tpu_torch.parallel import mesh as tm
    dev = grid[0].device
    D = MESH_SHARDS
    t0 = time.time()
    sh = tm.shard_ref_index(idx, D)
    mesh = tm.Mesh([dev] * D, ctx_shards=D)
    p = CodecParams()
    c, d, ln = grid

    def run():
        return tm.align_blocks_index_sharded(
            mesh, p, sh, c, d, ln, n_seeds=p.rescue_seeds,
            excl_bp=p.seed_excl_bp, n_cand=p.seed_max_occ)

    got = run()
    torch.cuda.synchronize()
    print(f"  k = 14 index in {D} key-range shards (kp {sh['kp']}), "
          f"uploaded: {time.time() - t0:.1f} s")
    saved = {n: getattr(kernels, n) for n in _K19}
    for n in _K19:
        setattr(kernels, n, getattr(kernels, n + "_plain"))
    try:
        want, pms = _timed(run)
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)
    err = max(int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
              for a, b in zip(got, want))
    ms = _time_ms(run, 3)
    k8 = (rows["k14_fwd"]["align_batch"][1], rows["k14_rc"]["align_batch"][1]
          ) if "k14_fwd" in rows else (float("nan"),) * 2
    print(f"  k14_sharded_D{D}      sharded_align B = {len(ln)}: "
          f"{int(got[0].sum())} mapped, max_abs_err {err}  kernel {ms:10.3f}"
          f" ms  plain {pms:10.3f} ms  (K8 tier 1 fwd {k8[0]:.3f} ms, RC "
          f"{k8[1]:.3f} ms)")
    if err:
        raise AssertionError(f"sharded_align: kernel differs from its plain "
                             f"version ({err})")
    rows[f"k14_sharded_D{D}"] = {"sharded_align": (err, ms, pms)}
    _k19_split(run, ms)
    _k19_launches(run)
    # bound: per strand and read, every shard's search of each valid
    # seed (a (hi, lo) key pair a step), the positions listed and the
    # W + 1 reference words of each listed candidate, plus the grids and
    # the outputs
    cfg = AlignConfig(k=14, stride=2, n_cand=p.seed_max_occ, max_mis=7,
                      both_strands=0, lp=ALIGN_LP, n_seeds=p.rescue_seeds,
                      excl_bp=p.seed_excl_bp, probe_k=1 << 30)
    steps = max(1, int(np.ceil(np.log2(sh["kp"] + 1))))
    W = ALIGN_LP // 16
    byts = _nbytes(c, d, ln) + sum(a.nbytes for a in got)
    ops = 0
    for cc, dd in ((c, d), kernels._rc_grid(c, d, ln.long())):
        n_seed, cands, _, _ = _seed_work(ix, cfg, cc, dd, ln)
        byts += int(n_seed.sum()) * D * steps * 8 + int(cands.sum()) * (
            4 + (W + 1) * 4)
        ops += (int(n_seed.sum()) * D * steps * 6
                + int(cands.sum()) * (W + 1) * _VERIFY_OPS)
    BOUNDS["sharded_align"] = (byts, ops, None)
    del sh, mesh


def _genome_fastq(path: str, R: int = 300_000, ids: str = "sra",
                  rc_frac: float = 0.0, indel_frac: float = 0.0,
                  genome_len: int = GENOME_LEN) -> int:
    """R x 100 bp reads from a seeded random genome (100 Mbp by default),
    ~1% substitutions, ~0.1% N, qualities from a seeded first-order Markov
    chain over 40 Phred values; SRA-style IDs, or Illumina-style ones
    (tile, x, y from a second seeded stream).  rc_frac of the reads are
    reverse-complemented and indel_frac carry a 1-3 bp deletion, both
    drawn from a third seeded stream (at 0 the input is unchanged).
    Returns the read count."""
    rng = np.random.default_rng(SEED)
    G = genome_len
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    starts = rng.integers(0, G - READ_LEN, R)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    if rc_frac or indel_frac:
        xrng = np.random.default_rng(SEED + 3)
        sel = np.flatnonzero(xrng.random(R) < indel_frac)
        at = xrng.integers(20, READ_LEN - 20, len(sel))
        gap = xrng.integers(1, 4, len(sel))
        i = np.arange(READ_LEN)[None, :]
        src = starts[sel, None] + i + np.where(i >= at[:, None],
                                               gap[:, None], 0)
        codes[sel] = genome[np.minimum(src, G - 1)]
        rc = xrng.random(R) < rc_frac
        codes[rc] = 3 - codes[rc, ::-1]
    sub = rng.random(codes.shape) < 0.01
    codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    seq = np.frombuffer(b"ACGT", np.uint8)[codes]
    seq[rng.random(seq.shape) < 0.001] = ord("N")
    qual = _markov_quals(rng, R)
    if ids == "illumina":
        irng = np.random.default_rng(SEED + 1)
        xy = irng.integers(1000, 32000, (R, 2))
        heads = [b"@A00123:45:HXXXXDSXX:1:%d:%d:%d 1:N:0:ACGTACGT\n"
                 % (1101 + r // 4000, xy[r, 0], xy[r, 1]) for r in range(R)]
    else:
        heads = _sra_heads(R)
    _write_fastq(path, heads, seq, qual)
    return R


def _sra_heads(R: int):
    return [b"@SRR0000001.%d %d length=100\n" % (r + 1, r + 1)
            for r in range(R)]


def _write_fastq(path: str, heads, seq, qual) -> None:
    with open(path, "wb") as fh:
        for r in range(len(heads)):
            fh.write(heads[r] + seq[r].tobytes() + b"\n+\n"
                     + qual[r].tobytes() + b"\n")


def _markov_quals(rng, R: int) -> np.ndarray:
    """(R, 100) Phred+33 qualities from a seeded first-order Markov chain:
    states 0..39 = Phred 2..41, a band around the current value, drifting
    down along the read."""
    S = 40
    P = np.exp(-np.abs(np.arange(S)[None, :] - np.arange(S)[:, None]
                       + 0.6) / 1.5)
    P[:, -1] += 0.02
    P /= P.sum(axis=1, keepdims=True)
    flat = (np.cumsum(P, axis=1) + np.arange(S)[:, None]).ravel()
    st = np.minimum(rng.geometric(0.08, R), S) - 1
    st = S - 1 - st
    q = np.empty((R, READ_LEN), np.uint8)
    for i in range(READ_LEN):
        q[:, i] = st
        u = rng.random(R)
        st = np.minimum(np.searchsorted(flat, st + u, side="right") - st * S,
                        S - 1)
    return (q + 2 + 33).astype(np.uint8)


def _pe_fastq(path1: str, path2: str, genome, R: int = R_PAIRS,
              seedless_frac: float = 0.0) -> int:
    """R pairs of 100 bp from ``genome``: mate 1 forward at s, mate 2 the
    reverse complement ending at s + insert (insert uniform in 200-500),
    ~1% substitutions and ~0.1% N on both, identical SRA IDs in both
    files, qualities as _genome_fastq's.  A seedless_frac share of the
    pairs carry instead a mate 2 with exactly the 7 substitutions at
    SEEDLESS_AT and no other, and no N in either mate.  The one at 91
    writes a smaller base code than the genome's: on the aligned strand
    the first seed's key then sorts above the true 14-mer, so the
    aligner's no-hit fallback (the candidates listed from that key's
    insertion point on, hash.py _one_strand) cannot reach the true
    locus, and the mate maps only through the insert window.  Returns
    the seedless count."""
    rng = np.random.default_rng(SEED + 5)
    G = len(genome)
    s = rng.integers(0, G - 600, R)
    ins = rng.integers(200, 501, R)
    i = np.arange(READ_LEN)[None, :]
    m1 = genome[s[:, None] + i]
    m2 = genome[(s + ins - READ_LEN)[:, None] + i][:, ::-1]
    m2 = 3 - m2
    for m in (m1, m2):
        sub = rng.random(m.shape) < 0.01
        m[sub] = (m[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    true2 = 3 - genome[(s + ins - READ_LEN)[:, None] + i][:, ::-1]
    seedless = ((rng.random(R) < seedless_frac * 4 / 3)
                & (true2[:, SEEDLESS_AT[-1]] > 0))
    clean = true2[seedless]
    clean[:, SEEDLESS_AT] = (clean[:, SEEDLESS_AT] + rng.integers(
        1, 4, (len(clean), len(SEEDLESS_AT)))) % 4
    clean[:, SEEDLESS_AT[-1]] = rng.integers(
        0, true2[seedless, SEEDLESS_AT[-1]])
    m2[seedless] = clean
    bases = np.frombuffer(b"ACGT", np.uint8)
    heads = _sra_heads(R)
    for path, m in ((path1, m1), (path2, m2)):
        seq = bases[m]
        seq[(rng.random(seq.shape) < 0.001) & ~seedless[:, None]] = ord("N")
        _write_fastq(path, heads, seq, _markov_quals(rng, R))
    return int(seedless.sum())


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


_FROZEN_PATH = ("quant_pack", "frozen_encode_lanes", "compact_words",
                "frozen_decode")
_ADAPT_PATH = ("adapt_encode_walk", "rans_encode_sf", "compact_words",
               "adapt_decode")
_SEMI_PATH = ("semi_encode_walk", "rans_encode_sf", "compact_words",
              "semi_decode")
# the transfer packs: every fused encode unpacks its uploaded grid (K15),
# every decode packs its grid (K16) and a 6-bit quality grid also as
# nibbles + exceptions (K17)
_PACKS = ("unpack_grid", "pack_grid", "pack15")
# the frozen trainer's card scorer (pipeline/frozen.py _CardScorer): every
# CLI-default frozen training on the card scores its tables by K13's
# halves, narrow_rows and K20
_TRAIN_PATH = ("train_hist", "train_rows_sum", "narrow_rows", "hist_nll")


def _scored_on_card(stats, what: str) -> None:
    """The trainer of a frozen compress scored its tables on the card."""
    if stats.get("qctx_card_scores", 0) < 1 or "qctx_host_scores" in stats:
        raise AssertionError(f"{what}: the trainer did not score on the "
                             f"card: {stats.get('qctx_card_scores')} card, "
                             f"{stats.get('qctx_host_scores')} host scores")
    print(f"{what}: {stats['qctx_card_scores']} tables scored on the card")


def _input(tmp: str, name: str, R: int, ids: str = "sra") -> str:
    fq = os.path.join(tmp, name)
    t0 = time.time()
    _genome_fastq(fq, R, ids)
    print(f"input {name}: {R} reads, {os.path.getsize(fq)} bytes "
          f"({time.time() - t0:.1f} s to generate)")
    return fq


def _label(flags) -> str:
    """The CLI flags of a run, less ``--stats`` (which only prints the
    stage times to stderr)."""
    return " ".join(f for f in flags if f != "--stats") or "(defaults)"


def _inputs_argv(fq, fq2):
    return ["-1", fq] + (["-2", fq2] if fq2 else [])


def _round_trip_ok(back: str, fq: str, fq2) -> bool:
    """The decoded output(s) of prefix ``back`` equal ``fq`` (and
    ``fq2``)."""
    if fq2:
        return (_same_file(fq, back + "_1.fastq")
                and _same_file(fq2, back + "_2.fastq"))
    return _same_file(fq, back + ".fastq")


# every main-path run with an aligner kernel: (run, aligner kernel
# launches and CUDA-event ms by tier, align_s, encode s); printed as JSON
ALIGN_RUNS = []


class _AlignerTimes:
    """K8, K9 and K14 launches by tier over one run, each C launch between
    two CUDA events on its stream (the wrapper's host work, the output
    fills and the other block workers' launches stay outside): K8 by tier
    (fwd, rc, both: tier 1; rescue: the multi-seed tier) and Lp, K9 and
    K14 by Lp.  Installed on ops.kernels' module attributes, which
    align/hash.py and the wrappers call."""

    NAMES = ("align_batch", "indel_batch", "rescue_indel_fused")

    def __init__(self):
        import threading
        self.ev = []
        self.local = threading.local()   # the tier of this thread's call

    @staticmethod
    def _tier(name, args) -> str:
        if name == "align_batch":
            cfg = args[4]
            return (f"K8 {'rescue' if cfg.n_seeds > 1 else cfg.strand} "
                    f"Lp{cfg.lp}")
        return f"{'K9' if name == 'indel_batch' else 'K14'} Lp{args[0].shape[1]}"

    def _wrap(self, name, fn):
        def run(*args):
            self.local.tier = self._tier(name, args)
            return fn(*args)
        return run

    def _launch(self, fn, name, dev, *args, count=1):
        import torch
        if name not in self.NAMES:
            return self._orig_launch(fn, name, dev, *args, count=count)
        st = torch.cuda.current_stream(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(st)
        self._orig_launch(fn, name, dev, *args, count=count)
        e1.record(st)
        self.ev.append((getattr(self.local, "tier", name), e0, e1))

    def __enter__(self):
        from fastqueeze_tpu_torch.ops import kernels
        self._orig = {n: getattr(kernels, n) for n in self.NAMES}
        for n, fn in self._orig.items():
            setattr(kernels, n, self._wrap(n, fn))
        self._orig_launch = kernels._launch
        kernels._launch = self._launch
        return self

    def __exit__(self, *exc):
        from fastqueeze_tpu_torch.ops import kernels
        for n, fn in self._orig.items():
            setattr(kernels, n, fn)
        kernels._launch = self._orig_launch

    def summary(self) -> dict:
        """{tier: {"launches", "ms"}}, sorted by tier."""
        import torch
        torch.cuda.synchronize()
        by = {}
        for tier, e0, e1 in self.ev:
            d = by.setdefault(tier, {"launches": 0, "ms": 0.0})
            d["launches"] += 1
            d["ms"] += e0.elapsed_time(e1)
        return dict(sorted(by.items()))


def _report_aligner(tag: str, at: "_AlignerTimes", stats, t_enc: float):
    """Prints and records one run's aligner kernel time beside its
    align_s (the --stats stage timer; None without --stats)."""
    by = at.summary()
    if not by:
        return
    tot = sum(v["ms"] for v in by.values())
    align_s = stats.get("align_s") if stats else None
    print(f"aligner kernels {tag}: {json.dumps(by)}; total {tot:.3f} ms "
          f"(CUDA events) beside align_s {align_s}, encode {t_enc:.3f} s")
    ALIGN_RUNS.append({"run": tag, "kernels": by, "kernel_ms": tot,
                       "align_s": align_s, "encode_s": t_enc})


def _drive(fq: str, n_reads: int, arc: str, flags, path_kernels, totals,
           ref=None, fq2=None, want=None, tag=None):
    """One main-path run through the CLI (against ``ref`` when given;
    paired with ``fq2`` when given): counts set to 0 just before, read
    just after; the decode equals the input (or ``want``, for -l) byte
    for byte; every kernel of the path launched; no native coder or
    aligner call; the aligner kernels' launches and time by tier
    (_AlignerTimes) printed beside align_s under ``tag``.  Adds the
    launches to ``totals``; returns (launches, the compress call's stage
    metrics)."""
    from fastqueeze_tpu_torch import cli
    from fastqueeze_tpu_torch.utils.metrics import DebugInfo
    runs = []

    class Recorded(DebugInfo):     # the CLI's metrics of each call
        def __init__(self):
            super().__init__()
            runs.append(self)

    _reset_counts()
    back = arc + ".back"
    refs = [ref] if ref else []
    cli.DebugInfo = Recorded
    t0 = time.time()
    try:
        with _AlignerTimes() as at:
            rc = cli.main(["-c"] + refs + _inputs_argv(fq, fq2)
                          + ["-o", arc, "-f"] + flags)
    finally:
        cli.DebugInfo = DebugInfo
    if rc != 0:
        raise RuntimeError("compress failed")
    t_enc = time.time() - t0
    _report_aligner(tag or _label(flags), at, runs[0].vals, t_enc)
    t0 = time.time()
    if cli.main(["-d"] + refs + [arc, "-o", back, "-f"]) != 0:
        raise RuntimeError("decompress failed")
    t_dec = time.time() - t0
    if not _round_trip_ok(back, want or fq, fq2):
        raise AssertionError("round trip differs from the input")
    size = sum(os.path.getsize(f) for f in (fq, fq2) if f)
    arc_size = os.path.getsize(arc)
    print(f"end to end {_label(flags)}: encode "
          f"{t_enc:.3f} s = {n_reads / t_enc:.0f} reads/s, decode "
          f"{t_dec:.3f} s = {n_reads / t_dec:.0f} reads/s, ratio "
          f"{size / arc_size:.4f} ({arc_size} bytes); byte-exact")
    return _read_counts(path_kernels, totals), runs[0].vals


def _reset_counts() -> None:
    """Kernel launches and native coder / aligner calls set to 0."""
    from fastqueeze_tpu_torch.io import native as nat
    from fastqueeze_tpu_torch.ops import host_adapt, host_frozen, kernels
    kernels.reset_launch_counts()
    for calls in (host_frozen.NATIVE_CALLS, host_adapt.NATIVE_CALLS,
                  nat.ALIGN_CALLS):
        for k in calls:
            calls[k] = 0


def _read_counts(path_kernels, totals):
    """The launches since _reset_counts: every kernel of the path launched
    and no native coder or aligner ran; adds them to ``totals``."""
    from fastqueeze_tpu_torch.io import native as nat
    from fastqueeze_tpu_torch.ops import host_adapt, host_frozen, kernels
    launches = dict(kernels.LAUNCHES)
    # (an older tree's kernels, run by --coders in turns, have no count
    # by mode)
    for mode, v in getattr(kernels, "UNPACK_MODES", {}).items():
        UNPACK_BY_MODE[mode] = UNPACK_BY_MODE.get(mode, 0) + v
    native = {"frozen": dict(host_frozen.NATIVE_CALLS),
              "adaptive": dict(host_adapt.NATIVE_CALLS),
              "aligner": dict(nat.ALIGN_CALLS)}
    print(f"kernel launches in the main path: {launches}; native coder / "
          f"aligner calls: {native}")
    missing = [k for k in path_kernels if launches[k] < 1]
    if missing:
        raise AssertionError(f"kernels of the path never launched: "
                             f"{missing}")
    if any(sum(c.values()) for c in native.values()):
        raise AssertionError(f"native coder or aligner ran on the card "
                             f"path: {native}")
    for k, v in launches.items():
        totals[k] += v
    return launches


def _oracle(fq: str, arc: str, flags, env: str, ref=None, fq2=None,
            want=None):
    """The same input compressed with ``env``=host (the native coder or
    aligner, bit-identical to the JAX package's host path; execution
    routing only) must give the same archive, which must decode on the
    card."""
    from fastqueeze_tpu_torch import cli
    arc_h = arc + ".host.fqz"
    refs = [ref] if ref else []
    os.environ[env] = "host"
    t0 = time.time()
    try:
        if cli.main(["-c"] + refs + _inputs_argv(fq, fq2)
                    + ["-o", arc_h, "-f"] + flags) != 0:
            raise RuntimeError("host-routed compress failed")
    finally:
        del os.environ[env]
    print(f"host-routed encode ({env}=host): {time.time() - t0:.3f} s")
    if not _same_file(arc, arc_h):
        raise AssertionError(f"card archive != native-host archive ({env})")
    if cli.main(["-d"] + refs + [arc_h, "-o", arc_h + ".back", "-f"]) != 0:
        raise RuntimeError("decode of the host archive failed")
    if not _round_trip_ok(arc_h + ".back", want or fq, fq2):
        raise AssertionError("host archive decoded on the card differs")
    print(f"oracle ({env}=host): archive equals the native-host archive "
          f"byte for byte; decodes on the card")


def _fused_too(fq: str, n_reads: int, arc: str, flags, path_kernels,
               totals, ref: str, tag: str, fq2=None) -> None:
    """A main-path run again with FASTQUEEZE_FUSED_ALIGN=1 (K8's tier 1 on
    both strands, then one K14 a batch); its archive must equal ``arc``,
    the classic chain's."""
    arc_f = arc + ".fused.fqz"
    os.environ["FASTQUEEZE_FUSED_ALIGN"] = "1"
    try:
        _drive(fq, n_reads, arc_f, flags, path_kernels, totals, ref=ref,
               fq2=fq2, tag=tag)
    finally:
        del os.environ["FASTQUEEZE_FUSED_ALIGN"]
    if not _same_file(arc, arc_f):
        raise AssertionError(f"{tag}: fused archive != classic archive")
    print(f"{tag}: archive equals the classic chain's byte for byte")
    os.remove(arc_f)


def frozen_end_to_end(tmp: str, totals) -> None:
    """Phases 4-5: the frozen path, and its archive == the native-host
    one."""
    print("phase 4-5: frozen path")
    fq = _input(tmp, "in.fq", 300_000)      # the archive names its input
    arc = os.path.join(tmp, "frozen.fqz")
    _, stats = _drive(fq, 300_000, arc, [],
                      _FROZEN_PATH + _PACKS + _TRAIN_PATH, totals)
    _scored_on_card(stats, "frozen path")
    _oracle(fq, arc, [], "FASTQUEEZE_FROZEN_EXEC")
    os.remove(fq)


def end_to_end(tmp: str):
    """Phases 4-7; returns the launches summed over the main-path runs."""
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    from fastqueeze_tpu_torch.container.encap import iter_tlv
    from fastqueeze_tpu_torch.ops import kernels
    from fastqueeze_tpu_torch.pipeline.blockcodec import TAG_IDVAR
    totals = {k: 0 for k in kernels.LAUNCHES}
    frozen_end_to_end(tmp, totals)

    print("phase 6: adaptive path (under the usemodel gate)")
    fq = _input(tmp, "adaptive.fq", R_ADAPT)
    for flags in ([], ["--qlevel", "3"]):
        arc = os.path.join(tmp, f"adaptive{len(flags)}.fqz")
        _drive(fq, R_ADAPT, arc, flags, _ADAPT_PATH + _PACKS, totals)
        with ArcReader(arc) as r:
            if r.model_blob is not None:
                raise AssertionError("adaptive input wrote a frozen model")
        _oracle(fq, arc, flags, "FASTQUEEZE_ADAPT_EXEC")
    os.remove(fq)

    print("phase 7: marker-1 ID stream on the frozen path")
    fq = _input(tmp, "illumina.fq", 250_000, ids="illumina")
    arc = os.path.join(tmp, "illumina.fqz")
    launches, _ = _drive(fq, 250_000, arc, [], _FROZEN_PATH + _ADAPT_PATH,
                         totals)
    with ArcReader(arc) as r:
        n_blocks = len(r.blocks)
        idvar = dict(iter_tlv(r.read_block(0)))[TAG_IDVAR]
    if n_blocks < 2 or idvar[:1] != b"\x01":
        raise AssertionError(f"expected >= 2 blocks and a marker-1 ID "
                             f"stream, got {n_blocks} blocks, marker "
                             f"{idvar[:1]!r}")
    print(f"block 0 ID stream: marker 1, {len(idvar)} bytes coded by K5/K7 "
          f"({launches['adapt_encode_walk']} walks), decoded by K6 "
          f"({launches['adapt_decode']} decodes)")
    return totals


def _mapped(arc: str):
    """(mapped reads, reads, blocks carrying the AMAP stream)."""
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    from fastqueeze_tpu_torch.container.encap import iter_tlv
    from fastqueeze_tpu_torch.pipeline.blockcodec import TAG_AMAP, TAG_META
    nm = n = amap = 0
    with ArcReader(arc) as r:
        for i in range(len(r.blocks)):
            secs = dict(iter_tlv(r.read_block(i)))
            meta = json.loads(secs[TAG_META])
            nm += meta["nm"]
            n += meta["R"]
            amap += TAG_AMAP in secs
    return nm, n, amap


def _refuses(argv, what: str) -> None:
    from fastqueeze_tpu_torch import cli
    if cli.main(argv) == 0:
        raise AssertionError(f"decode {what} did not fail")
    print(f"decode {what}: refused with a message (see above)")


def aligned_end_to_end(tmp: str, genome, totals, fused: bool = False,
                       selfref: bool = True) -> str:
    """Phases 8-9, adding their launches to ``totals``; returns the path
    of ref.fa (its index file beside it).  ``fused``: each phase 8 input
    also through the fused aligner flow; ``selfref``: run phase 9."""
    from fastqueeze_tpu_torch import cli
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    print("phase 8: reference-aligned SE")
    ref = os.path.join(tmp, "ref.fa")
    t0 = time.time()
    lines = np.frombuffer(b"ACGT", np.uint8)[genome].reshape(-1, 100)
    with open(ref, "wb") as fh:
        fh.write(b">genome seeded\n")
        fh.write(np.concatenate([lines, np.full((len(lines), 1), 10,
                                                np.uint8)], 1).tobytes())
    print(f"ref.fa: {os.path.getsize(ref)} bytes ({time.time() - t0:.1f} s)")
    t0 = time.time()
    if cli.main(["-i", ref]) != 0:
        raise RuntimeError("index build failed")
    print(f"-i ref.fa: {time.time() - t0:.1f} s")
    for name, R, flags, path in (
            ("aligned.fq", 300_000, ["--stats"],
             _FROZEN_PATH + ("align_batch",)),
            ("aligned_q.fq", R_ADAPT, ["-q", "--stats"],
             _ADAPT_PATH + ("align_batch", "indel_batch"))):
        fq = os.path.join(tmp, name)
        t0 = time.time()
        _genome_fastq(fq, R, rc_frac=0.3, indel_frac=0.05)
        print(f"input {name}: {R} reads, {os.path.getsize(fq)} bytes, 30% "
              f"reverse strand, 5% with a deletion ({time.time() - t0:.1f} "
              f"s to generate)")
        arc = fq[:-3] + ".fqz"
        tag = f"phase 8 {_label(flags)}"
        _drive(fq, R, arc, flags, path, totals, ref=ref, tag=tag)
        if fused:
            _fused_too(fq, R, arc, flags, ("align_batch",), totals, ref,
                       tag + " fused")
        nm, n, _ = _mapped(arc)
        print(f"mapped fraction {_label(flags)}: "
              f"{nm / n:.4f} ({nm} of {n} reads)")
        _oracle(fq, arc, flags, "FASTQUEEZE_ALIGN_EXEC", ref=ref)
        if "-q" not in flags:
            _refuses(["-d", arc, "-o", arc + ".x", "-f"],
                     "without the reference")
            wrong = os.path.join(tmp, "wrong.fa")
            with open(wrong, "wb") as fh:
                fh.write(b">w\nACGTACGTAC\n")
            _refuses(["-d", wrong, arc, "-o", arc + ".x", "-f"],
                     "with a wrong reference")
        os.remove(fq)
    if not selfref:
        return ref

    print("phase 9: self-referential blocks (coverage input, CLI defaults)")
    fq = os.path.join(tmp, "coverage.fq")
    t0 = time.time()
    _genome_fastq(fq, 300_000, rc_frac=0.5, genome_len=SELFREF_GENOME)
    print(f"input coverage.fq: 300000 reads over a {SELFREF_GENOME} bp "
          f"genome (60x), {os.path.getsize(fq)} bytes "
          f"({time.time() - t0:.1f} s)")
    arc = os.path.join(tmp, "coverage.fqz")
    _drive(fq, 300_000, arc, ["--stats"], _FROZEN_PATH, totals)
    nm, n, amap = _mapped(arc)
    with ArcReader(arc) as r:
        sa = r.params.self_align
    print(f"self-ref: PARAM self_align = {sa}, {amap} block(s) with AMAP, "
          f"mapped fraction {nm / n:.4f} ({nm} of {n} reads)")
    if sa != 1 or amap < 1:
        raise AssertionError("the auto probe did not turn self-ref on")
    os.remove(fq)
    return ref


def _slice_want(arc: str, srcs, at: int, count: int):
    """(start, count, the expected bytes of each source): ``count``
    records (PE: pairs) from ``at`` records before the end of block 0."""
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    with ArcReader(arc) as r:
        start = r.blocks[0].n_reads + at
    wants = []
    for src in srcs:
        with open(src, "rb") as fh:
            lines = fh.read().split(b"\n")
        wants.append(b"\n".join(lines[4 * start:4 * (start + count)]) + b"\n")
    return start, count, wants


def pe_end_to_end(tmp: str, genome, ref: str, totals, fused: bool = False,
                  no_ref: bool = True):
    """Phases 10-11, adding their launches to ``totals``; returns phase
    10's archive with a slice across its block 0/1 boundary, (archive,
    start, count, expected mate-1 and mate-2 bytes), for phase 16.
    ``fused``: phase 11's input also through the fused aligner flow;
    ``no_ref``: run phase 10 (else return None)."""
    fq1, fq2 = (os.path.join(tmp, f"pairs_{k}.fq") for k in (1, 2))
    pe_slice = _pe_no_ref(tmp, genome, fq1, fq2, totals) if no_ref else None
    _pe_ref(tmp, genome, ref, fq1, fq2, totals, fused)
    return pe_slice


def _pe_no_ref(tmp: str, genome, fq1: str, fq2: str, totals):
    """Phase 10; returns pe_end_to_end's slice."""
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    print("phase 10: paired-end, no reference (CLI defaults)")
    t0 = time.time()
    _pe_fastq(fq1, fq2, genome)
    size = os.path.getsize(fq1) + os.path.getsize(fq2)
    print(f"input pairs_1.fq / pairs_2.fq: {R_PAIRS} pairs, {size} bytes "
          f"({time.time() - t0:.1f} s to generate)")
    arc = os.path.join(tmp, "pairs.fqz")
    _, stats = _drive(fq1, 2 * R_PAIRS, arc, [], _FROZEN_PATH + _TRAIN_PATH,
                      totals, fq2=fq2)
    _scored_on_card(stats, "paired-end")
    with ArcReader(arc) as r:
        if len(r.blocks) < 2 or r.model_blob is None:
            raise AssertionError("expected a frozen PE archive of >= 2 "
                                 "blocks")
    _oracle(fq1, arc, [], "FASTQUEEZE_FROZEN_EXEC", fq2=fq2)
    return (arc,) + _slice_want(arc, (fq1, fq2), -10, 30)


def _pe_ref(tmp: str, genome, ref: str, fq1: str, fq2: str, totals,
            fused: bool) -> None:
    """Phase 11 (and its input again through the fused flow)."""
    from fastqueeze_tpu_torch.container.arcfile import FLAG_ALIGNED, ArcReader
    from fastqueeze_tpu_torch.container.encap import iter_tlv
    from fastqueeze_tpu_torch.pipeline.blockcodec import TAG_APDF
    from fastqueeze_tpu_torch.pipeline.pe import TAG_PE_BODY
    print("phase 11: paired-end against ref.fa with -I 500")
    t0 = time.time()
    n_seedless = _pe_fastq(fq1, fq2, genome, seedless_frac=0.05)
    print(f"input: {R_PAIRS} pairs, {n_seedless} seedless mate 2s "
          f"({time.time() - t0:.1f} s to generate)")
    arc = os.path.join(tmp, "pairs_ref.fqz")
    flags = ["-I", "500", "--stats"]
    _, stats = _drive(fq1, 2 * R_PAIRS, arc, flags,
                      _FROZEN_PATH + ("align_batch", "window_batch"), totals,
                      ref=ref, fq2=fq2, tag="phase 11 -I 500")
    if fused:
        _fused_too(fq1, 2 * R_PAIRS, arc, flags,
                   ("align_batch", "window_batch"), totals, ref,
                   "phase 11 -I 500 fused", fq2=fq2)
    rel = {k: stats.get(k, 0) for k in (
        "pe_rescued", "pe_both_map", "pe_1Y2N", "pe_1N2Y", "pe_none",
        "pe_insert_median", "mapped_reads")}
    print(f"pair relations: {json.dumps(rel)}")
    if rel["pe_rescued"] < 0.9 * n_seedless:
        raise AssertionError(f"pe_rescued {rel['pe_rescued']} < 0.9 x "
                             f"{n_seedless} seedless mates")
    with ArcReader(arc) as r:
        aligned = [i for i, b in enumerate(r.blocks)
                   if b.flags & FLAG_ALIGNED]
        apdf = [TAG_APDF in dict(iter_tlv(dict(iter_tlv(r.read_block(i)))[
            TAG_PE_BODY])) for i in aligned]
    print(f"{len(aligned)} aligned block(s), TAG_APDF in {sum(apdf)}")
    if not aligned or not all(apdf):
        raise AssertionError("an aligned PE block lacks TAG_APDF")
    _oracle(fq1, arc, flags, "FASTQUEEZE_ALIGN_EXEC", ref=ref, fq2=fq2)
    for f in (fq1, fq2):
        os.remove(f)


def semi_end_to_end(tmp: str, totals) -> None:
    """Phase 12: the CLI with AdaptChunk:64 in the config file -D wrote."""
    from fastqueeze_tpu_torch import cli
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    print("phase 12: semi-adaptive walk through the CLI (-D, AdaptChunk:64)")
    fq = _input(tmp, "adaptive.fq", R_ADAPT)
    work = os.path.join(tmp, "semi")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)             # the CLI reads ./fastqueeze.config
    try:
        if cli.main(["-D"]) != 0:
            raise RuntimeError("-D failed")
        with open("fastqueeze.config") as fh:
            conf = fh.read()
        if "AdaptChunk:0\n" not in conf:
            raise AssertionError("-D wrote no AdaptChunk:0 line")
        with open("fastqueeze.config", "w") as fh:
            fh.write(conf.replace("AdaptChunk:0\n",
                                  f"AdaptChunk:{SEMI_CHUNK}\n"))
        arc = os.path.join(tmp, "semi.fqz")
        launches, _ = _drive(fq, R_ADAPT, arc, [], _SEMI_PATH, totals)
    finally:
        os.chdir(cwd)
    with ArcReader(arc) as r:
        chunk, model = r.params.adapt_chunk, r.model_blob
    print(f"PARAM adapt_chunk = {chunk}; K11 {launches['semi_encode_walk']} "
          f"and K12 {launches['semi_decode']} launches")
    if (chunk != SEMI_CHUNK or model is not None
            or launches["semi_encode_walk"] < 2
            or launches["semi_decode"] < 2):
        raise AssertionError("phase 12: expected adapt_chunk 64, no model "
                             "and K11/K12 on seq and qual")
    os.remove(fq)


def _api_round_trip(fq: str, n_reads: int, arc: str, params, path,
                    totals) -> None:
    """api.compress then api.decompress on the card, counts set to 0 just
    before and read just after: byte-exact, a model in the archive, every
    kernel of ``path`` launched, no native coder call."""
    from fastqueeze_tpu_torch import api
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    _reset_counts()
    t0 = time.time()
    api.compress(fq, arc, params=params)
    t_enc = time.time() - t0
    t0 = time.time()
    out = api.decompress(arc, arc + ".back")
    t_dec = time.time() - t0
    if not _same_file(fq, out[0]):
        raise AssertionError("api round trip differs from the input")
    with ArcReader(arc) as r:
        if r.model_blob is None or not r.params.frozen_adapt:
            raise AssertionError("expected a frozen_adapt archive with a "
                                 "model")
    size, arc_size = os.path.getsize(fq), os.path.getsize(arc)
    print(f"api frozen_adapt=1 adapt_chunk={params.adapt_chunk}: encode "
          f"{t_enc:.3f} s = {n_reads / t_enc:.0f} reads/s, decode "
          f"{t_dec:.3f} s = {n_reads / t_dec:.0f} reads/s, ratio "
          f"{size / arc_size:.4f} ({arc_size} bytes); byte-exact")
    _read_counts(path, totals)


def frozen_adapt_end_to_end(tmp: str, totals) -> None:
    """Phase 13: frozen_adapt through the library API, and the engine's
    device trainer as a library user calls it."""
    import torch
    from fastqueeze_tpu_torch import api
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.models.base import QualModel
    from fastqueeze_tpu_torch.ops import engine
    from fastqueeze_tpu_torch.pipeline.frozen import (
        _cap_rescale, qual_ctx_flat)
    print("phase 13: adapting from frozen tables (api, frozen_adapt=1)")
    R = 60_000
    fq = _input(tmp, "frozen_adapt.fq", R)
    _api_round_trip(fq, R, os.path.join(tmp, "fa.fqz"),
                    CodecParams(frozen_adapt=1), _ADAPT_PATH, totals)
    _api_round_trip(fq, R, os.path.join(tmp, "fa_semi.fqz"),
                    CodecParams(frozen_adapt=1, adapt_chunk=SEMI_CHUNK),
                    _SEMI_PATH, totals)
    cut = os.path.join(tmp, "cut.fq")
    with open(fq, "rb") as src, open(cut, "wb") as dst:
        dst.write(b"".join(src.readline() for _ in range(4 * 5_000)))
    arcs = {}
    for dev in ("cuda", "cpu"):
        arcs[dev] = os.path.join(tmp, f"cut_{dev}.fqz")
        t0 = time.time()
        api.compress(cut, arcs[dev], params=CodecParams(
            use_model=1, frozen_adapt=1), device=dev)
        print(f"cut of 5,000 reads, use_model=1 frozen_adapt=1 on {dev}: "
              f"{time.time() - t0:.3f} s")
    if not _same_file(arcs["cuda"], arcs["cpu"]):
        raise AssertionError("card archive != the plain versions' archive")
    print("cut: the card's archive equals the plain versions' (CPU) archive")
    os.remove(fq)

    m = QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=2)
    p = CodecParams()
    lengths = np.full(R_ADAPT, READ_LEN, np.int64)
    q = (_markov_quals(np.random.default_rng(SEED + 8), R_ADAPT)
         - 35).reshape(-1)
    want = _cap_rescale(m, np.bincount(
        qual_ctx_flat(m, q, lengths) * 40 + q,
        minlength=m.n_ctx * 40).reshape(m.n_ctx, 40))
    _reset_counts()
    t0 = time.time()
    counts0 = engine.train_counts(m, p, q, lengths)
    payload = engine.encode_stream(m, p, q, lengths, counts0=counts0,
                                   adapt=True)
    back = engine.decode_stream(m, p, payload, lengths, counts0=counts0,
                                adapt=True)
    dt = time.time() - t0
    if not np.array_equal(counts0.cpu().numpy(), want):
        raise AssertionError("engine.train_counts != the host trainer")
    if not np.array_equal(back, q):
        raise AssertionError("counts0 stream round trip differs")
    fresh = engine.encode_stream(m, p, q, lengths, adapt=True)
    print(f"library: train_counts (== the host trainer's table) + "
          f"encode/decode from it: {len(payload)} bytes (fresh table "
          f"{len(fresh)}), {dt:.3f} s; byte-exact")
    _read_counts(("train_counts",) + _ADAPT_PATH, totals)


def _long_reads(rng, genome, n: int):
    """n reads of 3,000-20,000 bp from ``genome`` as 2-bit codes (0.3%
    substitutions, 10% with a 1-3 bp deletion or insertion, 30% reverse
    strand), each with its qualities: a seeded random walk over Phred
    2-41."""
    G = len(genome)
    out = []
    for _ in range(n):
        L = int(rng.integers(3000, 20001))
        st = int(rng.integers(0, G - L - 8))
        r = genome[st:st + L + 4].copy()
        if rng.random() < 0.1:
            at, g = int(rng.integers(100, L - 100)), int(rng.integers(1, 4))
            r = (np.concatenate([r[:at], r[at + g:]]) if rng.random() < 0.5
                 else np.concatenate([r[:at], rng.integers(0, 4, g).astype(
                     np.uint8), r[at:]]))
        r = r[:L]
        sub = rng.random(L) < 0.003
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        if rng.random() < 0.3:
            r = 3 - r[::-1]
        q = (np.clip(np.cumsum(rng.integers(-1, 2, L)) + 30, 2, 41)
             + 33).astype(np.uint8)
        out.append((r, q))
    return out


def _long_fastq(path: str, genome, n_long: int = 600,
                n_short: int = 60_000) -> None:
    """n_long reads of _long_reads (the last 5 exact duplicates of earlier
    ones) shuffled among n_short reads of 100 bp (~1% substitutions,
    ~0.1% N; qualities from _markov_quals)."""
    rng = np.random.default_rng(SEED + 9)
    G = len(genome)
    bases = np.frombuffer(b"ACGT", np.uint8)
    recs = [b"@LR%d length=%d\n%s\n+\n%s\n" % (
        i, len(r), bases[r].tobytes(), q.tobytes())
        for i, (r, q) in enumerate(_long_reads(rng, genome, n_long - 5))]
    for j in rng.integers(0, len(recs), 5):
        recs.append(recs[j])
    starts = rng.integers(0, G - READ_LEN, n_short)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    sub = rng.random(codes.shape) < 0.01
    codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    seq = bases[codes]
    seq[rng.random(seq.shape) < 0.001] = ord("N")
    qual = _markov_quals(rng, n_short)
    for r in range(n_short):
        recs.append(b"@SR%d\n%s\n+\n%s\n" % (r, seq[r].tobytes(),
                                              qual[r].tobytes()))
    with open(path, "wb") as fh:
        fh.write(b"".join(recs[j] for j in rng.permutation(len(recs))))


def longread_end_to_end(tmp: str, genome, ref: str, totals) -> None:
    """Phase 14: long reads against ref.fa, classic tiers and fused."""
    print("phase 14: long reads against ref.fa (chunk tier; defaults, "
          "then FASTQUEEZE_FUSED_ALIGN=1)")
    fq = os.path.join(tmp, "long.fq")
    t0 = time.time()
    _long_fastq(fq, genome)
    n = 600 + 60_000
    print(f"input long.fq: 600 reads of 3,000-20,000 bp among 60,000 of "
          f"100 bp, {os.path.getsize(fq)} bytes ({time.time() - t0:.1f} s "
          f"to generate)")
    from fastqueeze_tpu_torch.pipeline import frozen
    flags = ["--stats"]
    arcs = {}
    for tag, path in (("classic", _FROZEN_PATH + ("align_batch",
                                                  "indel_batch")),
                      ("fused", _FROZEN_PATH + ("align_batch",
                                                "rescue_indel_fused"))):
        arcs[tag] = os.path.join(tmp, f"long_{tag}.fqz")
        # both runs train and upload their tables cold, so their encode
        # times compare
        frozen._TRAIN_CACHE.clear()
        frozen._DESER_CACHE.clear()
        if tag == "fused":
            os.environ["FASTQUEEZE_FUSED_ALIGN"] = "1"
        try:
            _, stats = _drive(fq, n, arcs[tag], flags, path, totals,
                              ref=ref, tag=f"phase 14 {tag}")
        finally:
            os.environ.pop("FASTQUEEZE_FUSED_ALIGN", None)
        nm, nr, _ = _mapped(arcs[tag])
        print(f"{tag}: lr_chunks_mapped {int(stats.get('lr_chunks_mapped', 0))}"
              f", mapped reads {nm} of {nr}, align_s "
              f"{stats.get('align_s', 0):.3f}")
        if not stats.get("lr_chunks_mapped", 0):
            raise AssertionError("no long-read chunk mapped")
    _oracle(fq, arcs["classic"], flags, "FASTQUEEZE_ALIGN_EXEC", ref=ref)
    if not _same_file(arcs["fused"], arcs["classic"] + ".host.fqz"):
        raise AssertionError("fused archive != native-host archive")
    print("fused: archive equals the native-host archive byte for byte")
    os.remove(fq)


def lossy_mesh_end_to_end(tmp: str, totals) -> None:
    """Phase 15: -l 1.15 and --mesh 1 through the CLI, --mesh 2 refused."""
    import contextlib
    import io
    from fastqueeze_tpu_torch import cli
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    from fastqueeze_tpu_torch.pipeline.lossy import parse_lossy
    print("phase 15: -l 1.15 and --mesh 1 (phase 6's input)")
    fq = _input(tmp, "adaptive.fq", R_ADAPT)
    lossy = fq + ".lossy.fq"          # the port's transform of the input
    with open(fq, "rb") as fh:
        raw, _ = parse_lossy(CodecParams(lossy_factor=1.15), fh.read(), True)
    with open(lossy, "wb") as fh:
        fh.write(raw)
    for flags, want, field, value in (
            (["-l", "1.15"], lossy, "lossy_factor", 1.15),
            (["--mesh", "1"], None, "mesh_n", 1)):
        arc = os.path.join(tmp, f"p15_{field}.fqz")
        _drive(fq, R_ADAPT, arc, flags, _ADAPT_PATH, totals, want=want)
        _oracle(fq, arc, flags, "FASTQUEEZE_ADAPT_EXEC", want=want)
        with ArcReader(arc) as r:
            got = getattr(r.params, field)
        print(f"PARAM {field} = {got}")
        if got != value:
            raise AssertionError(f"PARAM {field} {got} != {value}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["-c", "-1", fq, "-o", os.path.join(tmp, "m2.fqz"),
                       "-f", "--mesh", "2"])
    msg = err.getvalue().strip()
    print(f"--mesh 2: exit {rc}, {msg!r}")
    if rc == 0 or "--mesh 2: only 1 device(s) visible" not in msg:
        raise AssertionError("--mesh 2 was not refused with the device "
                             "count")
    os.remove(fq)


R_MODES = 100_000        # ~24 MB of 100 bp reads: 3 blocks of 8 MB
MODES_BLOCK_MB = 8
MULTI_READS = (33_000, 33_100, 33_200)     # three files of ~8 MB


def modes_end_to_end(tmp: str, totals, pe_slice) -> None:
    """Phase 16: --part 0:3, 1:3, 2:3 and --merge, -X and -m through the
    CLI, each run's launches counted from 0 and read just after."""
    from fastqueeze_tpu_torch import cli
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    print("phase 16: --part K:3 + --merge, -X and -m through the CLI")
    fq = _input(tmp, "modes.fq", R_MODES)
    flags = ["--block-mb", str(MODES_BLOCK_MB)]
    single = os.path.join(tmp, "modes.fqz")
    _drive(fq, R_MODES, single, flags, _FROZEN_PATH + _PACKS, totals)
    _oracle(fq, single, flags, "FASTQUEEZE_FROZEN_EXEC")
    with ArcReader(single) as r:
        n_blocks = len(r.blocks)
        if n_blocks != 3 or r.model_blob is None:
            raise AssertionError(f"expected 3 frozen blocks, got {n_blocks}")

    parts = [os.path.join(tmp, f"part{k}.fqz") for k in range(3)]
    merged = os.path.join(tmp, "merged.fqz")
    _reset_counts()
    t0 = time.time()
    for k, part in enumerate(parts):
        if cli.main(["-c", "-1", fq, "-o", part, "-f", "--part", f"{k}:3"]
                    + flags) != 0:
            raise RuntimeError(f"--part {k}:3 failed")
    t_parts = time.time() - t0
    if cli.main(["--merge"] + parts + ["-o", merged, "-f"]) != 0:
        raise RuntimeError("--merge failed")
    # the frozen trainer's cache hands every part the single run's tables,
    # already quantized (K1) on the card
    _read_counts(("frozen_encode_lanes", "compact_words", "unpack_grid"),
                 totals)
    if not _same_file(merged, single):
        raise AssertionError("merged parts != the single-run archive")
    print(f"--part 0:3, 1:3, 2:3 ({t_parts:.3f} s) + --merge: equals the "
          f"single-run archive (and so the FASTQUEEZE_FROZEN_EXEC=host one)")

    with open(fq, "rb") as fh:
        lines = fh.read().split(b"\n")
    R = (len(lines) - 1) // 4
    start0 = _slice_want(single, [], -50, 100)[0]
    pe_arc, pe_start, pe_count, pe_wants = pe_slice
    for what, arc, start, count, wants in (
            ("SE block 0/1 boundary", single, start0, 100, [
                b"\n".join(lines[4 * start0:4 * (start0 + 100)]) + b"\n"]),
            ("SE tail", single, R - 40, 40,
             [b"\n".join(lines[4 * (R - 40):4 * R]) + b"\n"]),
            ("PE (phase 10) block 0/1 boundary", pe_arc, pe_start, pe_count,
             pe_wants)):
        out = os.path.join(tmp, "x")
        _reset_counts()
        t0 = time.time()
        if cli.main(["-d", arc, "-X", f"{start}:{count}", "-o", out,
                     "-f"]) != 0:
            raise RuntimeError(f"-X {what} failed")
        dt = time.time() - t0
        _read_counts(("frozen_decode",) + _PACKS[1:], totals)
        got = ([out + ".fastq"] if len(wants) == 1
               else [out + "_1.fastq", out + "_2.fastq"])
        for g, w in zip(got, wants):
            with open(g, "rb") as fh:
                if fh.read() != w:
                    raise AssertionError(f"-X {what}: != the input's lines")
        print(f"-X {start}:{count} ({what}, {dt:.3f} s): equals the input's "
              f"records")
    del lines

    ins = [_input(tmp, f"m{i}.fq", R_) for i, R_ in enumerate(MULTI_READS)]
    marc = os.path.join(tmp, "multi.fqz")
    back = os.path.join(tmp, "mback")
    _reset_counts()
    t0 = time.time()
    if cli.main(["-c", "-m"] + [a for f in ins for a in ("-1", f)]
                + ["-o", marc, "-f"]) != 0:
        raise RuntimeError("-m compress failed")
    t_enc = time.time() - t0
    if cli.main(["-d", marc, "-o", back, "-f"]) != 0:
        raise RuntimeError("-m decompress failed")
    _read_counts(_FROZEN_PATH + _PACKS, totals)
    for i, f in enumerate(ins):
        if not _same_file(f, f"{back}{i}.fastq"):
            raise AssertionError(f"-m file {i} differs after the round trip")
    with ArcReader(marc) as r:
        fids = sorted({b.file_id for b in r.blocks})
        if r.params.multi != 1 or fids != [0, 1, 2] or r.model_blob is None:
            raise AssertionError(f"-m archive: multi {r.params.multi}, file "
                                 f"ids {fids}")
    size = sum(os.path.getsize(f) for f in ins)
    print(f"-m over 3 files ({size} bytes): encode {t_enc:.3f} s, ratio "
          f"{size / os.path.getsize(marc):.4f}; each file byte-exact")
    for f in ins + [fq]:
        os.remove(f)


R_PROFILE = 20_000         # phase 18's reads (adaptive path, ~4.8 MB)
PROFILE_RUNS = {}          # phase 18: each traced CLI call's summary


def _kernel_short(name: str) -> str:
    """A trace's kernel name without its namespace and arguments."""
    import re
    hit = re.search(r"(\w+)(<[^()]*>)?\(", name)
    return hit.group(1) + (hit.group(2) or "") if hit else name[:60]


def _trace_summary(path: str) -> dict:
    """A --profile trace: its traced window (the command's span,
    cli.RUN_SPAN), the device's busy ms and share in it (the union of the
    kernel, copy and memset records over the window), and the five
    kernels with the most device ms."""
    from fastqueeze_tpu_torch import cli
    evs = _chrome_events(path)
    span = [e for e in evs if e.get("name") == cli.RUN_SPAN
            and e.get("cat") == "user_annotation"]
    if len(span) != 1:
        raise AssertionError(f"{path}: {len(span)} command spans")
    lo, hi = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    recs = [r for r in _device_records(evs) if r[1] > lo and r[0] < hi]
    by = {}
    for a, b, name, cat in recs:
        if cat == "kernel":
            k = _kernel_short(name)
            by[k] = by.get(k, 0.0) + (b - a) / 1e3
    busy, window = _busy_ms([(a, b) for a, b, _, _ in recs], lo, hi), \
        (hi - lo) / 1e3
    return {"window_ms": window, "busy_ms": busy, "busy_share": busy / window,
            "device_records": len(recs),
            "kernel_ms": sum(by.values()),
            "top5_kernels_ms": dict(sorted(by.items(),
                                           key=lambda kv: -kv[1])[:5])}


def _cli_traced(argv, trace_dir: str) -> float:
    """The CLI with --profile trace_dir in a fresh process, as a user runs
    it (late in this long process torch.profiler has dropped a session's
    device records); returns its wall seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "fastqueeze_tpu_torch.cli"]
                       + argv + ["-f", "--profile", trace_dir], env=env,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{argv[0]} --profile failed ({r.returncode}):\n"
                           f"{r.stderr[-3000:]}")
    return time.perf_counter() - t0


def profile_end_to_end(tmp: str) -> None:
    """Phase 18: R_PROFILE reads (adaptive path) compressed and
    decompressed through the CLI with --profile, each in a fresh process
    (_cli_traced) with a trace directory of its own: byte-exact, the
    archive == the one written without --profile; each trace's busy share
    and five longest kernels printed."""
    from fastqueeze_tpu_torch import cli
    print("phase 18: --profile (a torch.profiler trace of a CLI compress "
          "and decompress, each in a fresh process)")
    fq = _input(tmp, "profile.fq", R_PROFILE)
    plain = os.path.join(tmp, "profile_plain.fqz")
    if cli.main(["-c", "-1", fq, "-o", plain, "-f"]) != 0:
        raise RuntimeError("compress failed")
    arc, back = os.path.join(tmp, "profile.fqz"), os.path.join(tmp, "prof")
    for tag, argv in (("compress", ["-c", "-1", fq, "-o", arc]),
                      ("decompress", ["-d", arc, "-o", back])):
        d = os.path.join(tmp, f"trace_{tag}")
        wall = _cli_traced(argv, d)
        PROFILE_RUNS[tag] = dict(
            _trace_summary(os.path.join(d, cli.TRACE_NAME)), wall_s=wall)
        r = PROFILE_RUNS[tag]
        print(f"  --profile {tag}: {wall:.3f} s wall (the process); traced "
              f"window {r['window_ms']:.3f} ms, device busy "
              f"{r['busy_ms']:.3f} ms = {100 * r['busy_share']:.2f}% (the "
              f"union of {r['device_records']} kernel / copy / memset "
              f"records); kernels {r['kernel_ms']:.3f} ms; the five longest "
              f"(device ms): {json.dumps(r['top5_kernels_ms'])}")
    if not _same_file(arc, plain):
        raise AssertionError("--profile changed the archive")
    if not _round_trip_ok(back, fq, None):
        raise AssertionError("--profile round trip differs from the input")
    print("  --profile: archive == the one written without it; round trip "
          "byte-exact")


def mesh_end_to_end(tmp: str, genome, ref: str, totals) -> None:
    """Phase 17: the mesh with MESH_SHARDS shards sharing the one card
    (visible_devices patched), each on a CUDA stream of its own: the
    library calls B15, B19, B16; block data-parallelism (mesh=2) on
    phase 16's input; the ctx-sharded decode (mesh=4) of a --qlevel 3
    frozen archive; the index-sharded aligner (SHARD_MIN_POSITIONS = 1)
    against ref.fa.  Each run's launches counted from 0."""
    import torch
    from fastqueeze_tpu_torch.parallel import mesh as tm
    print("phase 17: the mesh (library calls, block-DP, ctx-sharded "
          "decode, sharded aligner)")
    dev = torch.device("cuda", torch.cuda.current_device())
    real = tm.visible_devices

    def shards(kind="cuda"):
        return [dev if torch.device(kind).type == "cuda"
                else torch.device("cpu")] * MESH_SHARDS

    tm.visible_devices = shards
    print(f"visible_devices patched: {MESH_SHARDS} shards, every one on "
          f"{dev} ({torch.cuda.get_device_name(0)}), each on a CUDA stream "
          f"of its own; nothing here runs on two physical cards")
    try:
        _mesh_library(genome, ref, totals)
        _mesh_block_dp(tmp, totals)
        _mesh_ctx_decode(tmp, totals)
        _mesh_sharded_aligner(tmp, ref, totals)
    finally:
        tm.visible_devices = real


def _mesh_library(genome, ref: str, totals) -> None:
    """B15 on each B15_MESHES mesh (its launches and time printed), B19
    and B16 on (4, 1), counted as one library user's run; then each
    against the single-device kernels."""
    import torch
    from fastqueeze_tpu_torch.align.hash import AlignConfig
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.ops import engine, kernels
    from fastqueeze_tpu_torch.parallel import mesh as tm
    from fastqueeze_tpu_torch.pipeline import aligned
    dev = torch.device("cuda", torch.cuda.current_device())
    m, syms, cgrid, rng = _b15_inputs()
    Bk, Tk, Lk = syms.shape
    nh = engine._n_halve(m, Lk)
    al, _ = aligned.prepare_ref(CodecParams(), ref)      # phase 8's Aligner
    c, d, ln = (a.reshape((Bk, -1) + a.shape[1:]) for a in _align_reads(
        rng, genome, 1024 * Bk, "tier1"))
    cfg = AlignConfig(k=al.k, stride=2, n_cand=64, max_mis=7,
                      both_strands=0, lp=ALIGN_LP)
    _reset_counts()
    t0 = time.time()
    b15 = {}
    for nb, nc in B15_MESHES:
        before = dict(kernels.LAUNCHES)
        t1 = time.perf_counter()
        b15[nb, nc] = tm.train_counts_sharded(
            tm.make_mesh(MESH_SHARDS, ctx_shards=nc), m, syms, cgrid)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        got = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
               if v != before[k]}
        print(f"  B15 on a ({nb}, {nc}) mesh: {ms:.3f} ms (host clock, "
              f"to a synchronize), launches {json.dumps(got)}")
    enc = tm.encode_blocks_sharded(tm.make_mesh(MESH_SHARDS), m, nh, None,
                                   syms, cgrid)
    aln = tm.align_blocks_sharded(tm.make_mesh(MESH_SHARDS), al, cfg, c, d,
                                  ln)
    torch.cuda.synchronize()
    dt = time.time() - t0
    _read_counts(("train_hist", "train_rows", "train_rows_sum",
                  "adapt_encode_walk", "rans_encode_sf", "align_batch"),
                 totals)
    single = kernels.train_counts(
        torch.from_numpy(syms.reshape(Bk * Tk, Lk)).to(dev),
        torch.from_numpy(cgrid.reshape(-1, Lk)).to(dev), m)
    for shape, parts in b15.items():
        if not torch.equal(torch.cat(parts), single):
            raise AssertionError(f"B15: the mesh trainer on {shape} != K13 "
                                 f"on the blocks")
    ix = al.dev_index(dev)
    for b in range(Bk):
        s, cg = (torch.from_numpy(x[b]).to(dev) for x in (syms, cgrid))
        one = kernels.rans_encode_sf(kernels.adapt_encode_walk(s, cg, m, nh),
                                     cg)
        if not all(torch.equal(x, y) for x, y in zip(enc[b], one)):
            raise AssertionError(f"B19 block {b} != K5 -> K7 on one stream")
        one = kernels.align_batch(*(torch.from_numpy(x[b]).to(dev)
                                    for x in (c, d, ln)), ix, cfg)
        if not all(torch.equal(x, y) for x, y in zip(aln[b], one)):
            raise AssertionError(f"B16 block {b} != K8 on one device")
    print(f"library: train_counts_sharded (2 x 2, 4 x 1, 1 x 4) == K13, "
          f"encode_blocks_sharded == K5 -> K7, align_blocks_sharded == K8 "
          f"({Bk} blocks, {dt:.3f} s)")


def _mesh_block_dp(tmp: str, totals) -> None:
    """api.compress(mesh=2) on phase 16's input, the trainer's caches
    emptied first: every block payload and the model equal the single
    run's (phase 16's archive), PARAM carries mesh_n 2 and threads 2,
    decompress(mesh=2) is byte-exact, K1-K4 launched."""
    from fastqueeze_tpu_torch import api
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    from fastqueeze_tpu_torch.pipeline import driver
    from fastqueeze_tpu_torch.pipeline import frozen
    fq = _input(tmp, "modes.fq", R_MODES)
    single = os.path.join(tmp, "modes.fqz")
    arc = os.path.join(tmp, "mesh2.fqz")
    # the trainer's caches emptied, so the run quantizes its tables (K1)
    frozen._TRAIN_CACHE.clear()
    frozen._DESER_CACHE.clear()
    _reset_counts()
    t0 = time.time()
    api.compress(fq, arc, params=CodecParams(block_size_mb=MODES_BLOCK_MB),
                 mesh=2)
    t_enc = time.time() - t0
    t0 = time.time()
    out = driver.decompress(arc, arc + ".back", force=True, mesh=2)
    t_dec = time.time() - t0
    if not _same_file(fq, out[0]):
        raise AssertionError("mesh=2 round trip differs from the input")
    _read_counts(_FROZEN_PATH, totals)
    with ArcReader(single) as r1, ArcReader(arc) as r2:
        n = len(r1.blocks)
        if len(r2.blocks) != n or r1.model_blob != r2.model_blob:
            raise AssertionError("mesh=2: blocks or model differ")
        for i in range(n):
            if r1.read_block(i) != r2.read_block(i):
                raise AssertionError(f"mesh=2 block {i} payload != the "
                                     f"single run's")
        got = (r2.params.mesh_n, r2.params.threads)
    if got != (2, 2):
        raise AssertionError(f"PARAM (mesh_n, threads) {got} != (2, 2)")
    print(f"block-DP mesh=2 ({n} blocks over 2 shards): encode "
          f"{t_enc:.3f} s = {R_MODES / t_enc:.0f} reads/s, decode "
          f"{t_dec:.3f} s = {R_MODES / t_dec:.0f} reads/s; every block "
          f"payload == the single run's, PARAM mesh_n 2 threads 2; "
          f"byte-exact")
    os.remove(fq)


def _mesh_ctx_decode(tmp: str, totals) -> None:
    """A frozen --qlevel 3 archive (use_model=1, the fqz context: a 2^20-row
    qual table) decoded with mesh=4 (the real CTX_SHARD_MIN_ENTRIES gate:
    K18) and with mesh=0 (K4)."""
    from fastqueeze_tpu_torch import api
    from fastqueeze_tpu_torch.config import CodecParams
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    from fastqueeze_tpu_torch.pipeline import driver
    fq = _input(tmp, "ctx.fq", R_CTX)
    arc = os.path.join(tmp, "ctx_q3.fqz")
    t0 = time.time()
    # qctx_auto=0: the fqz context at qlevel 3 (2^20 rows), not a rank
    # chain the trainer's selection might pick
    api.compress(fq, arc, params=CodecParams(use_model=1, qlevel=3,
                                             qctx_auto=0))
    t_enc = time.time() - t0
    with ArcReader(arc) as r:
        from fastqueeze_tpu_torch.pipeline.frozen import deserialize_frozen
        qmax = deserialize_frozen(r.model_blob)["qmax"]
        entries = r.params.qual_nctx() * (qmax + 2)
    if entries < driver.CTX_SHARD_MIN_ENTRIES:
        raise AssertionError(f"q3 table {entries} entries: under the gate")
    print(f"--qlevel 3 frozen archive: {entries} qual table entries (gate "
          f"{driver.CTX_SHARD_MIN_ENTRIES}), encode {t_enc:.3f} s")
    times = {}
    for mesh, path in ((0, ("frozen_decode",)),
                       (MESH_SHARDS, ("frozen_decode", "ctx_shard_decode"))):
        _reset_counts()
        t0 = time.time()
        out = driver.decompress(arc, arc + f".m{mesh}", force=True,
                                mesh=mesh)
        times[mesh] = time.time() - t0
        if not _same_file(fq, out[0]):
            raise AssertionError(f"mesh={mesh} decode differs")
        got = _read_counts(path, totals)
        if mesh == 0 and got["ctx_shard_decode"]:
            raise AssertionError("mesh=0 took the sharded decode")
    print(f"ctx-sharded decode mesh={MESH_SHARDS}: {times[MESH_SHARDS]:.3f} s"
          f" = {R_CTX / times[MESH_SHARDS]:.0f} reads/s; mesh=0 (K4, whole "
          f"table): {times[0]:.3f} s = {R_CTX / times[0]:.0f} reads/s; "
          f"byte-exact")
    os.remove(fq)


def _mesh_sharded_aligner(tmp: str, ref: str, totals) -> None:
    """SHARD_MIN_POSITIONS = 1 and an empty reference cache: ref.fa's
    index goes to a ShardedAligner over the MESH_SHARDS shards; R_SHARD
    reads through the CLI (K19, no K8/K9), byte-exact; a 5,000-read cut's
    archive == the device="cpu" one."""
    from fastqueeze_tpu_torch import api
    from fastqueeze_tpu_torch.align import sharded
    from fastqueeze_tpu_torch.pipeline import aligned
    fq = os.path.join(tmp, "sharded.fq")
    _genome_fastq(fq, R_SHARD, rc_frac=0.3, indel_frac=0.05)
    real = sharded.SHARD_MIN_POSITIONS
    sharded.SHARD_MIN_POSITIONS = 1
    aligned._REF_CACHE.clear()
    try:
        arc = os.path.join(tmp, "sharded.fqz")
        got, _ = _drive(fq, R_SHARD, arc, [],
                        ("sharded_align",) + _ADAPT_PATH, totals, ref=ref)
        kinds = {type(a).__name__ for a, _ in aligned._REF_CACHE.values()}
        if kinds != {"ShardedAligner"} or got["align_batch"] or got[
                "indel_batch"]:
            raise AssertionError(f"aligner {kinds}, K8 {got['align_batch']}"
                                 f" K9 {got['indel_batch']} launches")
        nm, n, _ = _mapped(arc)
        print(f"ShardedAligner ({MESH_SHARDS} shards): mapped fraction "
              f"{nm / n:.4f} ({nm} of {n} reads)")
        cut = os.path.join(tmp, "sharded_cut.fq")
        with open(fq, "rb") as src, open(cut, "wb") as dst:
            dst.write(b"".join(src.readline() for _ in range(4 * 5_000)))
        arcs = {}
        for dev in ("cuda", "cpu"):
            aligned._REF_CACHE.clear()
            arcs[dev] = os.path.join(tmp, f"sharded_cut_{dev}.fqz")
            t0 = time.time()
            api.compress(cut, arcs[dev], reference=ref, device=dev)
            print(f"sharded cut of 5,000 reads on {dev}: "
                  f"{time.time() - t0:.3f} s")
        if not _same_file(arcs["cuda"], arcs["cpu"]):
            raise AssertionError("sharded cut: card archive != the plain "
                                 "versions' (CPU) archive")
        print("sharded cut: the card's archive equals the plain versions' "
              "(CPU) archive")
    finally:
        sharded.SHARD_MIN_POSITIONS = real
        aligned._REF_CACHE.clear()
    os.remove(fq)


_REPLACES = {
    "align_batch": ("fastqueeze_tpu_torch/csrc/align_batch.cu",
                    "fastqueeze_tpu/align/hash.py:414"),
    "indel_batch": ("fastqueeze_tpu_torch/csrc/indel_batch.cu",
                    "fastqueeze_tpu/align/hash.py:515"),
    "quant_pack": ("fastqueeze_tpu_torch/csrc/quant_pack.cu",
                   "fastqueeze_tpu/ops/engine.py:544"),
    "frozen_encode_lanes": ("fastqueeze_tpu_torch/csrc/frozen_encode.cu",
                            "fastqueeze_tpu/ops/engine.py:832"),
    "compact_words": ("fastqueeze_tpu_torch/csrc/compact_words.cu",
                      "fastqueeze_tpu/ops/engine.py:509"),
    "frozen_decode": ("fastqueeze_tpu_torch/csrc/frozen_decode.cu",
                      "fastqueeze_tpu/ops/engine.py:683"),
    "adapt_encode_walk": ("fastqueeze_tpu_torch/csrc/adapt_encode.cu",
                          "fastqueeze_tpu/ops/engine.py:170"),
    "rans_encode_sf": ("fastqueeze_tpu_torch/csrc/rans_encode.cu",
                       "fastqueeze_tpu/ops/engine.py:832"),
    "adapt_decode": ("fastqueeze_tpu_torch/csrc/adapt_decode.cu",
                     "fastqueeze_tpu/ops/engine.py:861"),
    "window_batch": ("fastqueeze_tpu_torch/csrc/window_batch.cu",
                     "fastqueeze_tpu/align/hash.py:797"),
    "semi_encode_walk": ("fastqueeze_tpu_torch/csrc/semi_encode.cu",
                         "fastqueeze_tpu/ops/engine.py:578"),
    "semi_decode": ("fastqueeze_tpu_torch/csrc/semi_decode.cu",
                    "fastqueeze_tpu/ops/engine.py:608"),
    "train_counts": ("fastqueeze_tpu_torch/csrc/train_counts.cu",
                     "fastqueeze_tpu/ops/engine.py:523"),
    "rescue_indel_fused": ("fastqueeze_tpu_torch/csrc/rescue_indel_fused.cu",
                           "fastqueeze_tpu/align/hash.py:472"),
    "unpack_grid": ("fastqueeze_tpu_torch/csrc/transfer_pack.cu",
                    "fastqueeze_tpu/ops/engine.py:216"),
    "pack_grid": ("fastqueeze_tpu_torch/csrc/transfer_pack.cu",
                  "fastqueeze_tpu/ops/engine.py:223"),
    "pack15": ("fastqueeze_tpu_torch/csrc/transfer_pack.cu",
               "fastqueeze_tpu/ops/engine.py:972"),
    "train_hist": ("fastqueeze_tpu_torch/csrc/train_counts.cu",
                   "fastqueeze_tpu/parallel/mesh.py:87"),
    "train_rows": ("fastqueeze_tpu_torch/csrc/train_counts.cu",
                   "fastqueeze_tpu/parallel/mesh.py:87"),
    "train_rows_sum": ("fastqueeze_tpu_torch/csrc/train_counts.cu",
                       "fastqueeze_tpu/parallel/mesh.py:87"),
    "ctx_shard_decode": ("fastqueeze_tpu_torch/csrc/ctx_shard_decode.cu",
                         "fastqueeze_tpu/parallel/mesh.py:250"),
    "sharded_align": ("fastqueeze_tpu_torch/csrc/sharded_align.cu",
                      "fastqueeze_tpu/parallel/mesh.py:201"),
    "hist_nll": ("fastqueeze_tpu_torch/csrc/hist_nll.cu",
                 "fastqueeze_tpu/pipeline/frozen.py:278"),
    "narrow_rows": ("fastqueeze_tpu_torch/csrc/hist_nll.cu",
                    "fastqueeze_tpu/pipeline/frozen.py:734"),
}


def _ok_line() -> None:
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def aligner_main() -> int:
    """--aligner: phases 1-2, phase 3's aligner kernels (K8, K9, K10, K14,
    K19 against their plain versions; K8 and K9 also timed at several
    batch sizes), and the aligned phases 8, 11 and 14, each phase 8 and
    11 input also through the fused flow; the aligner kernels' launches
    and time by tier beside align_s."""
    card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fastqueeze_tpu_torch.ops import kernels
    build()
    genome = _genome()
    rows = check_align_kernels(genome, sweep=True)
    totals = {k: 0 for k in kernels.LAUNCHES}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ref = aligned_end_to_end(tmp, genome, totals, fused=True,
                                 selfref=False)
        pe_end_to_end(tmp, genome, ref, totals, fused=True, no_ref=False)
        longread_end_to_end(tmp, genome, ref, totals)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"aligner_kernels": {
        tag: {n: {"max_abs_err": e, "ms": ms, "plain_ms": pms}
              for n, (e, ms, pms) in r.items()} for tag, r in rows.items()},
        "pair_ms": PAIR_MS, "sweep_ms": SWEEP}))
    print(json.dumps({"aligner_runs": ALIGN_RUNS}))
    _ok_line()
    return 0


def coders_main() -> int:
    """--coders: phases 1-2, phase 3's coder kernels (K1-K7, K11-K13) and
    packs (K15-K17) against their plain versions, with K2's forward /
    reverse split, K11's and K17's device split and K12's cluster and
    boundary share, then phases 4-5 (frozen), 12
    (semi-adaptive) and 13 (frozen_adapt).  It runs from an older tree's
    copy too (copy this file into it), so two trees compare in turns in
    one call."""
    card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fastqueeze_tpu_torch.ops import kernels
    build()
    rows = check_kernels()
    rows.update(check_pack_kernels())
    rows.update(check_adaptive_kernels())
    rows.update(check_semi_kernels())
    totals = {k: 0 for k in kernels.LAUNCHES}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        frozen_end_to_end(tmp, totals)
        semi_end_to_end(tmp, totals)
        frozen_adapt_end_to_end(tmp, totals)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"coder_kernels": {
        tag: {n: {"max_abs_err": e, "ms": ms, "plain_ms": pms}
              for n, (e, ms, pms) in r.items()} for tag, r in rows.items()},
        "k2_by_table": K2_SPLIT, "k12_by_stream": SEMI_SHAPE,
        "k11_by_stream": K11_SPLIT, "k17_by_grid": K17_SPLIT,
        "k3_by_table": K3_SPLIT, "chains": CHAIN, "launches": totals,
        "k15_by_mode": K15_SPLIT, "k16_by_mode": K16_SPLIT,
        "k1_by_table": K1_SPLIT,
        "unpack_grid_launches_by_mode": UNPACK_BY_MODE,
        "bounds_ms": {k: _bound_row(k)["bound_ms"] for k in BOUNDS
                      if k.startswith(("unpack_grid", "pack_grid",
                                       "quant_pack"))},
        "library_parts_ms": {k: v for k, v in PAIR_MS.items()
                             if k.startswith(("unpack_grid",
                                              "quant_pack"))}}))
    _ok_line()
    return 0


def pack_window_main() -> int:
    """--pack-window: phases 1-2, then K16 in modes 2, 4 and 6 on phase
    3's grids and K10 at Lp 128 and 256 on phase 3's mates over the
    seeded genome's packed reference, each against its plain version,
    with CUDA-event and device times (torch.profiler) and bounds; no
    index and no end-to-end phase.  It runs from an older tree's copy too
    (copy this file into it), so two trees' K16 and K10 compare in turns
    in one call, each in a fresh process."""
    card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    from fastqueeze_tpu_torch.align.ref import pack_2bit
    from fastqueeze_tpu_torch.ops import engine
    build()
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = list(_coder_cases(dev))
    lay, seq_g = cases[0][2], cases[0][4]
    del cases
    grids = dict(_qual_grids(dev, lay), seq=seq_g)
    rows = {}

    def row(key, name, got, want, run, plain, reps=10):
        _pack_row(rows, key, name, got, want, run, plain, reps)

    for gname, mode in (("seq", 2), ("markov40", 6), ("markov14", 4),
                        ("uniform48", 6)):
        key = f"{gname}_mode{mode}"
        packed = engine._pack_host(grids[gname].cpu().numpy(), mode)
        _check_pack_grid(key, grids[gname], mode, packed, row, rows)
    del grids, seq_g
    genome = _genome()
    packed = torch.from_numpy(pack_2bit(genome).view(np.int32)).to(dev)
    _check_window_kernel(packed, len(genome), genome, rows)
    print(json.dumps({"pack_window": {
        "rows": {tag: {n: {"max_abs_err": e, "ms": ms, "plain_ms": pms}
                       for n, (e, ms, pms) in r.items()}
                 for tag, r in rows.items()},
        "k16_by_mode": K16_SPLIT, "k10_by_lp": K10_SPLIT,
        "bounds": {k: _bound_row(k) for k in BOUNDS}}}))
    _ok_line()
    return 0


def shards_main() -> int:
    """--shards: phases 1-2, then phase 3's K18 (K4 and route (a) at D = 2
    and 4, route (b) with the D = 4 shards in CTX_GROUPS groups), K4 at
    L_WIDE lanes (its several-lanes-a-thread variant) and K19
    (B = 4096 tier-1 reads, Lp 128, the k = 14 index in MESH_SHARDS
    key-range shards) against their plain versions, each with its device
    time by kernel (torch.profiler) and bound; no other kernel and no
    end-to-end phase.  It runs from an older tree's copy too (copy this
    file into it), so two trees' K18 and K19 compare in turns in one
    call, each in a fresh process."""
    card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    from fastqueeze_tpu_torch.align.hash import Aligner
    from fastqueeze_tpu_torch.align.index import build_from_ref
    from fastqueeze_tpu_torch.align.ref import RefSeq
    from fastqueeze_tpu_torch.config import CodecParams
    build()
    check_ctx_shard_kernel(split=True)
    check_k4_wide()
    genome = _genome()
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.time()
    p = CodecParams(seed_len=14)
    idx = build_from_ref(RefSeq(genome, np.zeros(len(genome), bool), ["g"],
                                np.array([0, len(genome)]), ""), p)
    ix = Aligner(idx, p).dev_index(dev)
    grid = tuple(torch.from_numpy(a).to(dev) for a in _align_reads(
        np.random.default_rng(SEED + 4), genome, 4096, "tier1"))
    print(f"  index k = 14 built and uploaded in {time.time() - t0:.1f} s")
    _check_sharded_kernel(idx, ix, grid, {})
    print(json.dumps({"shards": {
        "k18": K18_SPLIT, "k4_q3_ms": PAIR_MS["k4_q3"], "k4_wide": K4_WIDE,
        "k19": K19_SPLIT,
        "bounds": {k: _bound_row(k) for k in ("ctx_shard_decode",
                                              "sharded_align")}}}))
    _ok_line()
    return 0


def main() -> int:
    card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    build()
    rows = check_kernels()
    rows.update(check_pack_kernels())
    rows.update(check_adaptive_kernels())
    rows.update(check_semi_kernels())
    check_row_pass(rows)
    b15_split()
    rows.update(check_ctx_shard_kernel())
    rows.update(check_nll())
    genome = _genome()
    rows.update(check_align_kernels(genome))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = end_to_end(tmp)
        ref = aligned_end_to_end(tmp, genome, launches)
        pe_slice = pe_end_to_end(tmp, genome, ref, launches)
        semi_end_to_end(tmp, launches)
        frozen_adapt_end_to_end(tmp, launches)
        longread_end_to_end(tmp, genome, ref, launches)
        lossy_mesh_end_to_end(tmp, launches)
        modes_end_to_end(tmp, launches, pe_slice)
        mesh_end_to_end(tmp, genome, ref, launches)
        profile_end_to_end(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seq = dict(rows["adapt_seq_order10"], **rows["seq_order10"],
               **rows["k14_fwd"], **rows["k22_indel_G3_ops2"],
               **rows["k14_window"], **rows["semi_seq_order10_fresh"],
               **rows["train_seq_order10"], **rows["k22_fused"],
               **rows["seq_mode2"], **rows["markov40_pack15"],
               **rows["train_split_seq_order10"],
               **rows["rows_seq_order10"],
               **rows[f"qual_q3_D{MESH_SHARDS}"],
               **rows[f"k14_sharded_D{MESH_SHARDS}"],
               **rows["nll_hash_k4_18_A40"], **rows["nll_seq_order10_m0"])
    seq["pack_grid"] = rows["markov40_mode6"]["pack_grid"]
    BOUNDS["rescue_indel_fused"] = BOUNDS["k22_fused"]
    for tag in ("k14_fused", "k22_fused", "lr1024"):
        print(f"rescue_indel_fused {tag}: {_bound_row(tag)}; K8 rescue + "
              f"K9 separately {PAIR_MS[tag]:.3f} ms")
    table = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
              "launches": launches[k],
              "max_abs_err": max(r[k][0] for r in rows.values() if k in r),
              "ms": seq[k][1], "plain_ms": seq[k][2], **_bound_row(k)}
             for k, (src, rep) in _REPLACES.items()]
    # the long-read chunk tier's shape (Lp 1024) beside the Lp 128 rows
    by_name = {t["name"]: t for t in table}
    by_name["rescue_indel_fused"]["k8_rescue_plus_k9_ms"] = PAIR_MS[
        "k22_fused"]
    for key, name, tag in (("lp1024", "align_batch", "lr1024_tier1"),
                           ("lp1024_rescue", "align_batch", "lr1024_rescue"),
                           ("lp1024", "indel_batch", "lr1024_indel"),
                           ("lp1024", "rescue_indel_fused", "lr1024")):
        err, ms, pms = rows[tag][name]
        b = _bound_row(tag)
        by_name[name][key] = {"ms": ms, "plain_ms": pms, "max_abs_err": err,
                              "bound_ms": b["bound_ms"],
                              "bound_by": b["bound_by"]}
        print(f"{name} {tag}: {by_name[name][key]}")
    by_name["rescue_indel_fused"]["lp1024"]["k8_rescue_plus_k9_ms"] = (
        PAIR_MS["lr1024"])
    # the packs in every mode phase 3 ran, beside the rows' shapes (K15:
    # the seq grid in mode 2; K16: the Markov qualities in mode 6; K17:
    # the Markov qualities); no single PyTorch call computes K17, two
    # compute its parts
    for name in _PACKS:
        by_name[name]["modes"] = {
            key: {"ms": r[name][1], "plain_ms": r[name][2],
                  "max_abs_err": r[name][0]}
            for key, r in rows.items() if name in r}
    # K15 in every mode: device split, bound, the ranks' torch.cumsum;
    # its launches by mode in phases 4-18
    for key, m in by_name["unpack_grid"]["modes"].items():
        b = _bound_row(f"unpack_grid_{key}")
        m.update(device_ms_by_kernel=K15_SPLIT[key]["device_ms_by_kernel"],
                 bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        if f"unpack_grid_cumsum_{key}" in PAIR_MS:
            m["library_parts_ms"] = {
                "torch.cumsum (sentinel ranks)":
                    PAIR_MS[f"unpack_grid_cumsum_{key}"]}
    by_name["unpack_grid"]["launches_by_mode"] = UNPACK_BY_MODE
    # K16 in every mode: device split and bound; K10 at Lp 128 and 256
    for key, m in by_name["pack_grid"]["modes"].items():
        b = _bound_row(f"pack_grid_{key}")
        m.update(device_ms_by_kernel=K16_SPLIT[key]["device_ms_by_kernel"],
                 bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    by_name["window_batch"]["by_lp"] = K10_SPLIT
    by_name["pack15"]["library_parts_ms"] = {
        "torch.bincount": PAIR_MS["pack15_bincount"],
        "torch.masked_select": PAIR_MS["pack15_masked_select"]}
    by_name["quant_pack"]["by_table"] = {
        key: {"ms": r["quant_pack"][1], "plain_ms": r["quant_pack"][2],
              "max_abs_err": r["quant_pack"][0],
              "device_ms_by_kernel": K1_SPLIT[key[len("quant_pack_"):]][
                  "device_ms_by_kernel"],
              "bound_ms": _bound_row(key)["bound_ms"],
              "library_parts_ms": {"torch.cumsum(dim=1) (row scan)": PAIR_MS[
                  f"quant_pack_cumsum_{key[len('quant_pack_'):]}"]}}
        for key, r in rows.items() if key.startswith("quant_pack_")}
    # K4's cluster and time a wave on each table; K13's histogram on
    # qualities
    by_name["frozen_decode"]["cluster_by_table"] = K4_SHAPE
    # K5 and K6 on each adaptive stream of phase 3, with K6's cluster and
    # K5's heaviest row
    for name in ("adapt_encode_walk", "adapt_decode"):
        by_name[name]["by_stream"] = {
            tag: {"ms": rows[tag][name][1], "plain_ms": rows[tag][name][2],
                  "max_abs_err": rows[tag][name][0]}
            for tag in ADAPT_SHAPE}
    by_name["adapt_decode"]["cluster_by_stream"] = ADAPT_SHAPE
    by_name["rans_encode_sf"]["by_stream"] = {
        tag: {"ms": rows[tag]["rans_encode_sf"][1],
              "plain_ms": rows[tag]["rans_encode_sf"][2],
              "max_abs_err": rows[tag]["rans_encode_sf"][0]}
        for tag in ADAPT_SHAPE}
    # K2 on each frozen table (forward / reverse); K12 on each stream
    by_name["frozen_encode_lanes"]["by_table"] = K2_SPLIT
    # the reverse chains' ns a step and chain bound; K3's device split
    for name, chain in CHAIN.items():
        by_name[name]["chain"] = chain
    by_name["compact_words"]["by_table"] = K3_SPLIT
    by_name["semi_decode"]["by_stream"] = SEMI_SHAPE
    by_name["semi_encode_walk"]["by_stream"] = K11_SPLIT
    by_name["pack15"]["by_grid"] = K17_SPLIT
    by_name["train_hist"]["qual_markov40"] = PAIR_MS["train_hist_qual"]
    # the row pass on each table (in place and summing), B15's call split
    by_name["train_rows"]["by_table"] = ROWS
    by_name["train_rows_sum"]["b15_by_mesh"] = B15_SPLIT
    # K18 at each row-shard count, beside K4 on the same stream and table
    by_name["ctx_shard_decode"]["k4_same_stream_ms"] = PAIR_MS["k4_q3"]
    by_name["ctx_shard_decode"]["plain_waves"] = CTX_PLAIN_T
    by_name["ctx_shard_decode"]["by_shards"] = {
        f"D{D}": {"ms": rows[f"qual_q3_D{D}"]["ctx_shard_decode"][1],
                  "plain_ms": rows[f"qual_q3_D{D}"]["ctx_shard_decode"][2],
                  "max_abs_err": rows[f"qual_q3_D{D}"]["ctx_shard_decode"][0]}
        for D in MESH_DS}
    by_name["ctx_shard_decode"]["routes"] = K18_SPLIT
    by_name["sharded_align"]["device_split"] = K19_SPLIT
    by_name["sharded_align"]["k8_tier1_ms"] = {
        "fwd": rows["k14_fwd"]["align_batch"][1],
        "rc": rows["k14_rc"]["align_batch"][1]}
    # K20 on every table (device ms and bound), narrow_rows and the row
    # pass with inc on the quality tables, _select_qctx by scorer
    by_name["hist_nll"]["by_table"] = NLL
    print(f"copies of one stream (phase 3): {json.dumps(COPY)}")
    print(json.dumps({"aligner_runs": ALIGN_RUNS}))
    print(f"unpack_grid launches by pack mode (phases 4-18): "
          f"{json.dumps(UNPACK_BY_MODE)}")
    print(json.dumps({"profile_runs": PROFILE_RUNS}))
    print(json.dumps({"kernels": table}))
    _ok_line()
    return 0


def coder_loop(reps: int, blocking: bool, build_dir, checked: bool) -> None:
    """Phase 3's K1 -> K2 -> K3 launches on its inputs, then K17, K11
    (chunk 64, two halvings), K7 on K11's sf, K15 on the host's mode
    15 and 23 packs of the same grids and K16 on the grids (mode 2 for
    seq, 6 for qualities), and K10 on phase 3's mates at Lp 128 and 256
    over a 4 Mbp cut of the seeded genome, ``reps`` rounds, each
    launch announced before it starts, so that under CUDA_LAUNCH_BLOCKING=1
    the last line names a launch that faults.  ``blocking``: synchronize
    after every launch; else only where phase 3 does (reading K1's result
    before K2; K2 followed at once by the plain version's first op,
    cgrid.long(), which reported the fault in phase 3).  ``build_dir``:
    build the kernel library there first (this process's own build), else
    load the parent's; ``checked``: the checked build (every FQK_CHECK
    bound live).  The first round is held against the plain versions,
    every later one against the first."""
    import torch
    from fastqueeze_tpu_torch.ops import kernels
    t0 = time.time()
    info = kernels.build(checked=checked, build_dir=build_dir)
    print(f"library {info['path']} (checked {info['checked']}): "
          f"{time.time() - t0:.1f} s", flush=True)
    from fastqueeze_tpu_torch.align.ref import pack_2bit
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = list(_coder_cases(dev))
    sent = {}                    # (tag, mode) -> K15's pack and sidecar
    for tag, _, _, _, g, _, _ in cases:
        for mode in (15, 23):
            packed, side, _ = _sent_pack(g.cpu().numpy(), mode)
            sent[tag, mode] = (torch.from_numpy(packed).to(dev), mode,
                               torch.from_numpy(side).to(dev))
    # K10's mates over a 4 Mbp cut of the seeded genome, at phase 3's Lps
    genome = _genome(4_000_000)
    ref = torch.from_numpy(pack_2bit(genome).view(np.int32)).to(dev)
    mates = {lp: (ref, len(genome)) + tuple(
        torch.from_numpy(a).to(dev) for a in _window_reads(
            np.random.default_rng(SEED + 6), genome, 4096, WINDOW_C, lp, n))
        + (WINDOW_C, 7) for lp, n in WINDOW_LPS}
    want = {}
    for rep in range(reps):
        for tag, m, _, _, g, c, cg in cases:
            print(f"launch quant_pack round {rep} {tag}", flush=True)
            k1 = kernels.quant_pack(c)
            if blocking:
                torch.cuda.synchronize()
            if tag not in want:
                want[tag] = kernels.quant_pack_plain(c)
            if not all(torch.equal(a, b) for a, b in zip(k1, want[tag])):
                raise AssertionError(f"round {rep} {tag}: K1 differs")
            print(f"launch frozen_encode_lanes round {rep} {tag}", flush=True)
            k2 = kernels.frozen_encode_lanes(g, cg, k1[1], m)
            if blocking:
                torch.cuda.synchronize()
            cg.long()
            key = tag + "_k2"
            if key not in want:
                want[key] = kernels.frozen_encode_lanes_plain(g, cg, k1[1], m)
            if not all(torch.equal(a, b) for a, b in zip(k2, want[key])):
                raise AssertionError(f"round {rep} {tag}: K2 differs")
            for name, run, plain in (
                    ("compact_words",
                     lambda: kernels.compact_words(*k2[:2]),
                     lambda: kernels.compact_words_plain(*k2[:2])),
                    ("pack15", lambda: kernels.pack15(g, cg),
                     lambda: kernels.pack15_plain(g, cg)),
                    ("semi_encode_walk",
                     lambda: kernels.semi_encode_walk(g, cg, m, 2,
                                                      SEMI_CHUNK),
                     lambda: kernels.semi_encode_walk_plain(g, cg, m, 2,
                                                            SEMI_CHUNK)),
                    ("rans_encode_sf",        # on K11's sf (the plain's)
                     lambda: kernels.rans_encode_sf(
                         want[f"{tag}_semi_encode_walk"][0], cg),
                     lambda: kernels.rans_encode_sf_plain(
                         want[f"{tag}_semi_encode_walk"][0], cg)),
                    ("unpack_grid15",
                     lambda: [kernels.unpack_grid(*sent[tag, 15])],
                     lambda: [kernels.unpack_grid_plain(*sent[tag, 15])]),
                    ("unpack_grid23",
                     lambda: [kernels.unpack_grid(*sent[tag, 23])],
                     lambda: [kernels.unpack_grid_plain(*sent[tag, 23])]),
                    ("pack_grid",             # the decoded grid's pack
                     lambda: [kernels.pack_grid(g, 2 if m.alphabet == 4
                                                else 6)],
                     lambda: [kernels.pack_grid_plain(
                         g, 2 if m.alphabet == 4 else 6)])):
                print(f"launch {name} round {rep} {tag}", flush=True)
                got = run()
                if blocking:
                    torch.cuda.synchronize()
                key = f"{tag}_{name}"
                if key not in want:
                    want[key] = plain()
                if name == "compact_words":     # the dense prefix, count
                    got, want[key] = ((o[:int(c.item())], c)
                                      for o, c in (got, want[key]))
                if not all(torch.equal(a, b)
                           for a, b in zip(got, want[key])):
                    raise AssertionError(f"round {rep} {tag}: {name} "
                                         f"differs")
        for lp, args in mates.items():
            name = f"window_batch_lp{lp}"
            print(f"launch {name} round {rep}", flush=True)
            got = kernels.window_batch(*args)
            if blocking:
                torch.cuda.synchronize()
            if name not in want:
                want[name] = kernels.window_batch_plain(*args)
            mw = want[name][0]
            if not (torch.equal(got[0], mw) and all(
                    torch.equal(a[mw], b[mw])
                    for a, b in zip(got[1:], want[name][1:]))):
                raise AssertionError(f"round {rep}: {name} differs")
    torch.cuda.synchronize()


def coder_loop_procs(procs: int, reps: int, blocking: bool, own_build: bool,
                     checked: bool) -> int:
    """``--coder-loop PROCS ROUNDS [--async] [--own-build] [--checked]``:
    PROCS fresh processes, one after another, each running
    coder_loop(ROUNDS) (phase 3 once died on an illegal memory access
    right after K1/K2's first launch): under CUDA_LAUNCH_BLOCKING=1 unless
    --async; each loading the library this process builds, or with
    --own-build each building its own into an empty directory first;
    the checked build with --checked.  Prints each process's exit code and
    last launch, then the failure count; exits 1 if any process failed."""
    card()
    if not own_build:             # the library the children load
        from fastqueeze_tpu_torch.ops import kernels
        t0 = time.time()
        info = kernels.build(checked=checked)
        print(f"build: {time.time() - t0:.1f} s ({info['path']})")
    env = dict(os.environ)
    if blocking:
        env["CUDA_LAUNCH_BLOCKING"] = "1"
    else:
        env.pop("CUDA_LAUNCH_BLOCKING", None)
    failed = []
    tmp = tempfile.mkdtemp(prefix="coder_loop_")
    try:
        for i in range(procs):
            argv = ["--coder-child", str(reps)]
            if not blocking:
                argv.append("--async")
            if own_build:
                argv += ["--build-dir", os.path.join(tmp, f"build{i}")]
            if checked:
                argv.append("--checked")
            t0 = time.time()
            r = subprocess.run([sys.executable, os.path.abspath(__file__)]
                               + argv, env=env, capture_output=True,
                               text=True, timeout=900)
            launches = [ln for ln in r.stdout.splitlines()
                        if ln.startswith("launch ")]
            lib = [ln for ln in r.stdout.splitlines()
                   if ln.startswith("library ")]
            print(f"process {i}: exit {r.returncode} in "
                  f"{time.time() - t0:.1f} s, {len(launches)} launches, "
                  f"last {launches[-1:]}; {lib[:1]}")
            if r.returncode:
                failed.append(i)
                print(r.stdout[-2000:])
                print(r.stderr[-3000:])
            if own_build:
                shutil.rmtree(os.path.join(tmp, f"build{i}"),
                              ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"coder_loop": {
        "processes": procs, "rounds": reps, "launches_per_process": 29 * reps,
        "blocking": blocking, "own_build": own_build, "checked": checked,
        "failed_processes": failed}}))
    return 1 if failed else 0


def _sass_functions() -> list:
    """The built library's SASS (cuobjdump -sass), one string a kernel."""
    import re
    from fastqueeze_tpu_torch.ops import kernels
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", kernels.BUILD_INFO["path"]],
                          capture_output=True, text=True, check=True).stdout
    return re.split(r"\n(?=\s*Function : )", dump)


def sass_main(names, out_dir: str) -> int:
    """--sass NAME... [--out DIR]: builds the kernels and writes the SASS
    (cuobjdump -sass of the library) of each kernel whose mangled name
    holds a NAME to DIR/sass_<NAME>.txt; prints each kernel's instruction
    count and its reverse chain's loop (_chain_loop)."""
    import re
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fastqueeze_tpu_torch.ops import kernels
    kernels.build()
    funcs = _sass_functions()
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        hits = [f for f in funcs if re.match(rf"\s*Function : \S*{name}", f)]
        path = os.path.join(out_dir, f"sass_{name}.txt")
        with open(path, "w") as fh:
            fh.write("\n".join(hits))
        for f in hits:
            fn = f.split()[2]
            n = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", f, re.M))
            calls = [c.strip() for c in re.findall(r"(CALL\.[^;]*);", f)]
            print(f"{name}: {_kernel_name(fn)} {n} instructions -> {path}; "
                  f"{_chain_loop(f)}; calls: {calls or 'none'}")
    return 0


def _chain_loop(sass: str) -> str:
    """The loop of a kernel's SASS with the most steps of the reverse chain
    (an IMAD.HI.U32 of two registers, the quotient, each): its
    instructions and the sum of their stall counts (bits 41-44 of each
    instruction's control word: the cycles the scheduler waits before the
    next issue), a step."""
    import re
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);\s+/\* 0x[0-9a-f]{16} \*/"
                     r"\s+/\* 0x([0-9a-f]{16}) \*/", sass)
    rows = [(int(a, 16), op, int(hi, 16)) for a, op, hi in ins]
    best = None
    for addr, op, _ in rows:
        hit = re.search(r"BRA (?:`?\()?0x([0-9a-f]+)", op)
        if not hit or int(hit.group(1), 16) >= addr:
            continue
        body = [r for r in rows if int(hit.group(1), 16) <= r[0] <= addr]
        steps = sum(bool(re.match(
            r"IMAD\.HI\.U32 R\d+, R\d+(\.reuse)?, R\d+(\.reuse)?, RZ",
            b[1].strip())) for b in body)
        if steps and (best is None or steps > best[0]):
            best = (steps, len(body), sum((b[2] >> 41) & 15 for b in body))
    if best is None:
        return "no loop with a quotient"
    steps, n, stall = best
    return (f"chain loop: {steps} steps, {n} instructions ({n / steps:.1f} "
            f"a step), {stall} stall cycles ({stall / steps:.1f} a step)")


def _flag(name: str) -> bool:
    return name in sys.argv[2:]


def _opt(name: str):
    return (sys.argv[sys.argv.index(name) + 1] if name in sys.argv[2:]
            else None)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--coder-loop"]:
        sys.exit(coder_loop_procs(int(sys.argv[2]), int(sys.argv[3]),
                                  not _flag("--async"), _flag("--own-build"),
                                  _flag("--checked")))
    if sys.argv[1:2] == ["--aligner"]:
        sys.exit(aligner_main())
    if sys.argv[1:2] == ["--coders"]:
        sys.exit(coders_main())
    if sys.argv[1:2] == ["--pack-window"]:
        sys.exit(pack_window_main())
    if sys.argv[1:2] == ["--shards"]:
        sys.exit(shards_main())
    if sys.argv[1:2] == ["--rows"]:
        sys.exit(rows_main())
    if sys.argv[1:2] == ["--nll"]:
        sys.exit(nll_main())
    if sys.argv[1:2] == ["--sass"]:
        args = sys.argv[2:]
        out = _opt("--out") or "sass"
        if "--out" in args:
            del args[args.index("--out"):args.index("--out") + 2]
        sys.exit(sass_main(args, out))
    if sys.argv[1:2] == ["--coder-child"]:
        coder_loop(int(sys.argv[2]), not _flag("--async"),
                   _opt("--build-dir"), _flag("--checked"))
        sys.exit(0)
    sys.exit(main())
