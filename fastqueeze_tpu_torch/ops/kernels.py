"""The CUDA kernels, their wrappers and plain versions.

Frozen coder:
K1 quant_pack          count table -> u16 cumulative table + u32 packed
                       (start, end) words: a tile of rows through
                       shared memory, a row a thread (A <= 8) or a
                       group of 8-32 lanes, no division a symbol
                                                       (engine._quant_full)
K2 frozen_encode_lanes a thread per (chunk of waves, lane): K13's chunk
                       walk + the table gather + each freq's reciprocal;
                       then a thread a lane: reverse rANS, its loads
                       staged in shared memory ahead of the state chain
                       (engine._device_aux, context_grids, _pass1_frozen,
                       _pass2)
K3 compact_words       emitted words -> dense prefix + count in one
                       pass: tiles by atomic ticket, a block scan, the
                       tile's offset by a decoupled look-back
                       (engine._compact_words)
K4 frozen_decode       one thread-block cluster (up to 8 CTAs) per
                       stream, one lane a thread: per-wave lane walk, row
                       fetch + search in registers, rANS decode and a
                       renorm rank across the cluster
                       (engine._decode_frozen)
Adaptive coder:
K5 adapt_encode_walk   the table's rows walked in parallel: every slot's
                       context (K13's chunk walk), a stable radix sort of
                       the slots by context, then each row's events by
                       wave groups (pre-update quant, adds, halving), a
                       thread per light row and a warp per heavy one;
                       bound by the heaviest row's chain of groups
                       (engine._device_aux, context_grids, _pass1,
                       _wave_update_tot)
K7 rans_encode_sf      reverse rANS over K5's (start, end) grid, K2's
                       reverse chain with each divisor's reciprocal read
                       a stage ahead from a table the launch fills
                       (engine._pass2); then K3
K6 adapt_decode        K4's thread-block cluster with the table update:
                       per wave the row fetch + count search in
                       registers, the rank exchange, atomicAdd on the
                       table, an exchange with cluster-scope release /
                       acquire (and the halving, only on waves where a
                       row crossed cap); bound by each wave's chain of
                       L2 round trips and exchanges (engine._decode)
K5 and K6 start from a fresh table (init everywhere) or from a caller's
count table (counts0: a frozen table that keeps adapting).
Semi-adaptive walk (adapt_chunk; the table is snapshotted every chunk
waves):
K11 semi_encode_walk   lane contexts, then per chunk a row pass (halve,
                       snapshot) and a slot pass (gather, atomicAdd)
                       (engine._pass1_semi, _snapshot_sf, _rescale_full);
                       then K7 and K3
K12 semi_decode        per chunk a pass over the rows that can have
                       changed (the chunk's touched rows and the rows
                       still over cap: halve, snapshot), then K4's
                       thread-block cluster decodes the chunk's waves
                       against the snapshot (count search, rank exchange)
                       with fire-and-forget count adds
                       (engine._decode_semi)
Trainer:
K13 train_counts       a thread per (chunk of waves, lane), the walk's
                       state carried in at the chunk start, + atomicAdd
                       histogram, then the row init and cap rescale
                       (engine._train_counts); its
                       halves train_hist and the row pass on their own
                       for the mesh trainer (parallel/mesh.py
                       train_counts_sharded): the row pass sums a
                       device's block partials, adds init and halves,
                       a row's counts in registers (train_rows in place,
                       train_rows_sum over partials), weighing each
                       count by inc where the histogram is raw
K20 hist_nll           the code length of an evaluation histogram under a
                       table (frozen._hist_nll_bits, the cost model of
                       the trainer's quality contexts): the row totals,
                       then the nonzero cells' float64 terms compacted in
                       row-major order by tiles and K3's look-back, for
                       the host to sum; narrow_rows: a table in the type
                       it ships in (frozen._narrow_np), every step-th row
Mesh (parallel/mesh.py; the collectives between launches are its own):
K18 ctx_shard_decode   frozen decode with the table sharded by context
                       rows on K4's cluster: shards sharing a card in one
                       launch, the row read through the shards' row
                       pointers; shards on several cards one launch a
                       wave, one (sym, start, freq) partial a card summed
                       between the launches (mesh._build_frozen_sharded)
K19 sharded_align      gapless multi-seed alignment over a key-range
                       sharded index in u32 coordinates, one warp a read,
                       one entry point a phase: lookup, candidates,
                       verify, tail (align/hash.py _one_strand's
                       shard_axis branch, _align_batch)
Transfer packs (the (T, L) symbol grids cross the host link packed):
K15 unpack_grid        2/4/6-bit and sentinel (15, 23) packs -> grid,
                       16 slots a thread; the sentinel modes in one pass
                       with K3's look-back
                       (engine._unpack{2,4,6,15,23}_dev, _unpack_sent_dev)
K16 pack_grid          grid -> 2/4/6-bit pack (engine._pack{2,4,6}_dev)
K17 pack15             6-bit grid -> top-15 nibbles + exception list
                       (engine._pack15_dev)
Seed aligner:
K8 align_batch         one warp per read: sampled-seed bucketed search,
                       candidates, probe prefilter, gapless verify, RC,
                       32 lanes a step (align/hash.py _one_strand,
                       _align_batch)
K9 indel_batch         one warp per read: K8's seed search for the
                       anchor, then the <= 2-op split x gap scoring
                       (align/hash.py _indel_batch)
K10 window_batch       one warp per read: every offset of the mate's
                       insert window on both strands, first-occurrence
                       argmin (align/hash.py _window_batch)
K14 rescue_indel_fused one warp per todo slot of a tier-1 batch: K8's
                       rescue, then K9 on the slots it did not map
                       (align/hash.py _rescue_indel_fused)

The sources are csrc/*.cu with a plain C interface, compiled by nvcc for
sm_90a (one nvcc per source, in parallel) and linked into one shared
library at first use, loaded with ctypes.  A wrapper takes its plain
PyTorch version only for tensors on the CPU; for a CUDA tensor it launches
the kernel or raises.  Every launch adds one to ``LAUNCHES[name]``.

Unsigned types: u16 values travel in int16 tensors and u32 values in
int32 tensors (same bits); the plain versions widen to int64 and mask.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from fastqueeze_tpu_torch.config import PROB_BITS, RANS_L, RANS_M

LAUNCHES: Dict[str, int] = {"quant_pack": 0, "frozen_encode_lanes": 0,
                            "compact_words": 0, "frozen_decode": 0,
                            "adapt_encode_walk": 0, "rans_encode_sf": 0,
                            "adapt_decode": 0, "align_batch": 0,
                            "indel_batch": 0, "window_batch": 0,
                            "semi_encode_walk": 0, "semi_decode": 0,
                            "train_counts": 0, "rescue_indel_fused": 0,
                            "unpack_grid": 0, "pack_grid": 0, "pack15": 0,
                            "train_hist": 0, "train_rows": 0,
                            "train_rows_sum": 0,
                            "ctx_shard_decode": 0, "sharded_align": 0,
                            "hist_nll": 0, "narrow_rows": 0}
# K15's launches by pack mode (each also counts in LAUNCHES["unpack_grid"])
UNPACK_MODES: Dict[int, int] = {2: 0, 4: 0, 6: 0, 15: 0, 23: 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the checked build (build(checked=True)): the same sources with every
# FQK_CHECK bound live (csrc/check.cuh: print the kernel, index and bound,
# then __trap()), in its own directory
CHECK_FLAGS = ["-DFQK_CHECK", "-lineinfo"]

_LIB = None
_LIB_LOCK = threading.Lock()
_LIB_FROM: Tuple[str, bool] = (BUILD_DIR, False)   # (directory, checked)
BUILD_INFO: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, UNPACK_MODES):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _build(build_dir: str, checked: bool) -> str:
    """Compile csrc/ into <build_dir>/libfqkernels-<content hash>.so (once
    per source content and flags): one nvcc per .cu, all started together,
    then one link.  Returns the library's path; ptxas register/spill lines
    land in BUILD_INFO["ptxas"]."""
    flags = NVCC_FLAGS + (CHECK_FLAGS if checked else [])
    h = hashlib.sha256()
    for path in _sources():
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    h.update(" ".join(flags).encode())
    so = os.path.join(build_dir, f"libfqkernels-{h.hexdigest()[:16]}.so")
    log = so + ".log"
    if not os.path.exists(so):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"    # concurrent builders: last wins
        cus = [p for p in _sources() if p.endswith(".cu")]
        objs = [f"{tmp}.{os.path.basename(c)}.o" for c in cus]
        procs = [subprocess.Popen([_nvcc()] + flags + ["-c", "-o", o, c],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c, o in zip(cus, objs)]
        outs = [(c, p.communicate()[1], p.returncode)
                for c, p in zip(cus, procs)]
        bad = [f"{c} ({rc}):\n{err}" for c, err, rc in outs if rc != 0]
        if bad:
            raise RuntimeError("nvcc failed: " + "\n".join(bad))
        r = subprocess.run([_nvcc(), "-shared", "-o", tmp] + objs,
                           capture_output=True, text=True)
        for o in objs:
            os.remove(o)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        with open(log, "w") as fh:
            fh.write("".join(err for _, err, _ in outs))
        os.replace(tmp, so)
    ptxas = ""
    if os.path.exists(log):
        with open(log) as fh:
            ptxas = fh.read()
    BUILD_INFO.update(path=so, ptxas=ptxas, checked=checked)
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build(*_LIB_FROM))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            spec = [i32] + [i64] * 7
            lib.fq_quant_pack.argtypes = [vp, i64, i32, i32, vp, vp, vp]
            lib.fq_frozen_encode_lanes.argtypes = (
                [vp, vp, i32, i32, i32, vp, i64, i32] + spec + [vp] * 6)
            lib.fq_unpack_grid.argtypes = (
                [vp, i32, i32, i32, vp, i64, vp, i64, vp, vp])
            lib.fq_unpack_grid_scratch_bytes.argtypes = [i32, i64]
            lib.fq_unpack_grid_scratch_bytes.restype = i64
            lib.fq_pack_grid.argtypes = [vp, i32, i32, i32, vp, vp]
            lib.fq_pack15.argtypes = ([vp, vp, i32, i32, i32] + [vp] * 4
                                      + [i64, vp])
            lib.fq_pack15_scratch_bytes.argtypes = [i32, i32]
            lib.fq_pack15_scratch_bytes.restype = i64
            lib.fq_compact_words.argtypes = [vp, vp, i64, vp, vp, vp, vp]
            lib.fq_compact_words_scratch_bytes.argtypes = [i64]
            lib.fq_compact_words_scratch_bytes.restype = i64
            lib.fq_frozen_decode.argtypes = (
                [vp, vp, i64, vp, i32, i32, i32, vp, i32] + spec + [vp] * 3)
            lib.fq_adapt_encode_walk.argtypes = (
                [vp, vp, i32, i32, i32, vp, i32] + spec + [i32] * 4
                + [vp, i64, vp, vp, vp])
            lib.fq_adapt_encode_scratch_bytes.argtypes = [i32, i32, i64]
            lib.fq_adapt_encode_scratch_bytes.restype = i64
            lib.fq_rans_encode_sf.argtypes = [vp, vp, i32, i32, i32] + [vp] * 5
            lib.fq_rans_encode_sf_scratch_bytes.argtypes = []
            lib.fq_rans_encode_sf_scratch_bytes.restype = i64
            lib.fq_adapt_decode.argtypes = (
                [vp, vp, i64, vp, i32, i32, i32, vp, i32] + spec + [i32] * 3
                + [vp, vp, i64, vp, vp, vp])
            lib.fq_adapt_decode_scratch_bytes.argtypes = [i32, i64, i32]
            lib.fq_adapt_decode_scratch_bytes.restype = i64
            lib.fq_adapt_decode_shape.argtypes = [i32, i32, vp]
            semi = spec + [i64] + [i32] * 4 + [vp] * 2
            lib.fq_semi_encode_walk.argtypes = (
                [vp, vp, i32, i32, i32, i32] + semi + [vp] * 4)
            lib.fq_semi_encode_scratch_bytes.argtypes = [i32, i32, i64]
            lib.fq_semi_encode_scratch_bytes.restype = i64
            lib.fq_semi_decode.argtypes = (
                [vp, vp, i64, vp, i32, i32, i32, i32] + semi + [vp] * 3)
            lib.fq_semi_decode_scratch_bytes.argtypes = [i32, i64, i32]
            lib.fq_semi_decode_scratch_bytes.restype = i64
            lib.fq_semi_decode_shape.argtypes = [i32, i32, vp]
            lib.fq_train_counts.argtypes = (
                [vp, vp, i32, i32, vp, i32] + spec + [i64] + [i32] * 3
                + [vp, i32, vp, vp])
            lib.fq_train_hist.argtypes = (
                [vp, vp, i32, i32, vp, i32] + spec + [i32, vp, i32, vp, vp])
            lib.fq_chunk_scratch_bytes.argtypes = [i32, i32]
            lib.fq_chunk_scratch_bytes.restype = i64
            lib.fq_frozen_decode_shape.argtypes = [i32, i32, vp]
            lib.fq_train_rows.argtypes = [vp, i32, vp, i64, i32, i32, i32,
                                          i32, vp]
            lib.fq_hist_nll.argtypes = [vp, i32, vp, i64, i32, i32, vp, i64,
                                        vp, i64, vp, vp, vp]
            lib.fq_hist_nll_scratch_bytes.argtypes = [i64, i32]
            lib.fq_hist_nll_scratch_bytes.restype = i64
            lib.fq_narrow_rows.argtypes = [vp, i64, i32, i32, i32, vp, vp]
            shard = [vp, vp, i64, vp, i32, i32, i32, vp, i64, i32] + spec
            lib.fq_ctx_shard_run.argtypes = shard + [i32] + [vp] * 4
            lib.fq_ctx_shard_step.argtypes = (
                shard + [i32, i32, vp, i32] + [vp] * 5 + [i32, vp])
            lib.fq_sharded_lookup.argtypes = (
                [vp] * 3 + [i32] * 7 + [vp] * 3 + [i64, i32, i32]
                + [vp] * 4)
            lib.fq_sharded_candidates.argtypes = (
                [vp] + [i32] * 3 + [vp] * 3 + [i64, vp, i64] + [i32] * 4
                + [vp] * 4)
            lib.fq_sharded_verify.argtypes = (
                [vp] * 2 + [i32] * 3 + [vp] * 3 + [i32, i32, ctypes.c_uint32,
                                                   i64, i32, vp, i64, i32]
                + [vp] * 3)
            lib.fq_sharded_tail.argtypes = (
                [vp] * 3 + [i32] * 6 + [vp] * 5 + [i64] + [vp] * 5)
            for fn in (lib.fq_decode_lane_bytes, lib.fq_ctx_shard_state_words):
                fn.argtypes = []
                fn.restype = i64
            index = [vp, i32, i64, vp, vp, i64, vp, i64, vp, i32, i32, i32]
            acfg = [i32] * 8
            lib.fq_align_scratch_bytes.argtypes = acfg
            lib.fq_indel_scratch_bytes.argtypes = acfg + [i32]
            for fn in (lib.fq_align_scratch_bytes, lib.fq_indel_scratch_bytes):
                fn.restype = i64
            lib.fq_align_batch_cuda.argtypes = (
                index + acfg + [vp, vp, vp, i32, i32, i32, vp, i64]
                + [vp] * 5)
            lib.fq_indel_batch_cuda.argtypes = (
                index + acfg + [vp, vp, vp, i32, i32, i32, vp, i64]
                + [vp] * 9)
            lib.fq_rescue_indel_fused_cuda.argtypes = (
                index + acfg + [i32] + acfg + [i32] * 2 + [vp] * 3 + [i32]
                + [vp] * 2 + [i32] * 2 + [vp, i64] + [vp] * 13)
            lib.fq_window_batch_cuda.argtypes = (
                [vp, i64, i32, vp, vp, vp, vp, i32, i32, i32, i32]
                + [vp] * 4)
            for fn in (lib.fq_quant_pack, lib.fq_frozen_encode_lanes,
                       lib.fq_compact_words, lib.fq_frozen_decode,
                       lib.fq_adapt_encode_walk, lib.fq_rans_encode_sf,
                       lib.fq_adapt_decode, lib.fq_align_batch_cuda,
                       lib.fq_indel_batch_cuda, lib.fq_window_batch_cuda,
                       lib.fq_semi_encode_walk, lib.fq_semi_decode,
                       lib.fq_train_counts, lib.fq_rescue_indel_fused_cuda,
                       lib.fq_unpack_grid, lib.fq_pack_grid, lib.fq_pack15,
                       lib.fq_train_hist, lib.fq_train_rows,
                       lib.fq_hist_nll, lib.fq_narrow_rows,
                       lib.fq_frozen_decode_shape, lib.fq_adapt_decode_shape,
                       lib.fq_semi_decode_shape,
                       lib.fq_ctx_shard_run, lib.fq_ctx_shard_step,
                       lib.fq_sharded_lookup,
                       lib.fq_sharded_candidates, lib.fq_sharded_verify,
                       lib.fq_sharded_tail):
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def build(checked: bool = False, build_dir=None) -> Dict[str, object]:
    """Build (or load) the kernel library now; returns BUILD_INFO.

    checked: the checked build (CHECK_FLAGS), in <build_dir>/checked.
    build_dir: where to build (default the package's _build/).  A process
    loads one library: asking for another after the first launch
    raises."""
    global _LIB_FROM
    base = build_dir or BUILD_DIR
    want = (os.path.join(base, "checked") if checked else base, checked)
    with _LIB_LOCK:
        if _LIB is not None and want != _LIB_FROM:
            raise RuntimeError(f"kernel library already loaded from "
                               f"{_LIB_FROM}, not {want}")
        _LIB_FROM = want
    _lib()
    return BUILD_INFO


def _on_card(*tensors: torch.Tensor) -> bool:
    """False: all on the CPU (plain version).  True: all on one CUDA
    device (kernel; it launches on that device's current stream).
    Anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"kernels launch on CUDA devices, not {dev}")
    return True


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {ndim}-d {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous="
                         f"{t.is_contiguous()}")


def _launch(fn, name: str, dev: torch.device, *args, count: int = 1) -> None:
    """Call the C entry ``fn`` on ``dev`` (the tensors' device) and its
    current stream, so a block worker's launches stay on its card and its
    shard's stream; ``count`` kernels launched by the call."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")
    LAUNCHES[name] += count


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _spec_args(model):
    kind, vals = model.spec()
    vals = list(vals) + [0] * (7 - len(vals))
    return [kind] + vals


def _u16(t: torch.Tensor) -> torch.Tensor:
    return t.long() & 0xFFFF


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.long() & 0xFFFFFFFF


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bits."""
    return (v - ((v >> 31) & 1) * (1 << 32)).to(torch.int32)


def _to_i16(v: torch.Tensor) -> torch.Tensor:
    return (v - ((v >> 15) & 1) * (1 << 16)).to(torch.int16)


# --- K1 -----------------------------------------------------------------

# count-table types K1 reads: u8, u16 (in int16, same bits) and i32
_COUNT_WIDTH = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def _count_width(counts: torch.Tensor) -> int:
    """Bytes a count of the table takes (K1's ``width``)."""
    if counts.dtype not in _COUNT_WIDTH:
        raise ValueError(f"counts: want uint8, int16 (u16) or int32, got "
                         f"{counts.dtype}")
    return _COUNT_WIDTH[counts.dtype]


def quant_pack_plain(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_ctx, A) counts (u8, u16 in int16, or i32) -> ((n_ctx, A+1) int16
    cum, (n_ctx*A,) int32 packed F[s] | F[s+1] << 16)."""
    c = counts.long()
    if _count_width(counts) == 2:
        c = c & 0xFFFF
    cs = torch.cumsum(c, dim=1)
    C = torch.clamp(cs[:, -1:], min=1)
    F = torch.cat([torch.zeros_like(C), (cs * RANS_M) // C], dim=1)
    packed = F[:, :-1] | (F[:, 1:] << 16)
    return _to_i16(F), _to_i32(packed.reshape(-1))


def quant_pack(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1; the table is read in the type it travels in (u8, u16 in an
    int16 tensor, or i32)."""
    if not _on_card(counts):
        return quant_pack_plain(counts)
    width = _count_width(counts)
    _check(counts, "counts", counts.dtype, 2)
    n, A = counts.shape
    cum = torch.empty((n, A + 1), dtype=torch.int16, device=counts.device)
    packed = torch.empty((n * A,), dtype=torch.int32, device=counts.device)
    _launch(_lib().fq_quant_pack, "quant_pack", counts.device, _ptr(counts),
            n, A, width, _ptr(cum), _ptr(packed))
    return cum, packed


# --- B1 (inline in K2 and K4) ---------------------------------------------

def device_aux_plain(T: int, cgrid: torch.Tensor):
    """(J, L) per-slot read lengths -> valid (T, L) bool and aux
    {"start", "pos"}: a scatter-max of read starts and a cummax down the
    waves, zero-length slots dropped (engine._device_aux)."""
    J, L = cgrid.shape
    c = cgrid.long()
    dev = cgrid.device
    lane_len = c.sum(dim=0)
    t_idx = torch.arange(T, device=dev)[:, None]
    valid = t_idx < lane_len[None, :]
    s = torch.cumsum(c, dim=0) - c
    lanes = torch.arange(L, device=dev)[None, :].expand(J, L)
    keep = (c > 0) & (s < T)
    marks = torch.zeros((T, L), dtype=torch.int64, device=dev)
    marks.index_put_((s[keep], lanes[keep]), s[keep], accumulate=False)
    run_start = torch.cummax(marks, dim=0).values
    pos = t_idx - run_start
    start = t_idx == run_start
    return valid, {"start": start & valid,
                   "pos": torch.where(valid, pos, 0)}


# --- K2 -----------------------------------------------------------------

def pass2_plain(start: torch.Tensor, freq: torch.Tensor,
                valid: torch.Tensor):
    """Reverse-wave rANS over (T, L) int64 start/freq grids
    (engine._pass2).  Returns int16 words (0 at padding), uint8 emit and
    int32 final states."""
    T, L = start.shape
    x = torch.full((L,), RANS_L, dtype=torch.int64, device=start.device)
    words = torch.zeros((T, L), dtype=torch.int64, device=start.device)
    emits = torch.zeros((T, L), dtype=torch.bool, device=start.device)
    for t in range(T - 1, -1, -1):
        s, f, vld = start[t], freq[t], valid[t]
        emit = ((x >> 18) >= f) & vld
        words[t] = torch.where(vld, x & 0xFFFF, 0)
        emits[t] = emit
        x = torch.where(emit, x >> 16, x)
        fs = torch.clamp(f, min=1)
        q = x // fs
        xn = ((q << PROB_BITS) + (x - q * fs) + s) & 0xFFFFFFFF
        x = torch.where(vld, xn, x)
    return _to_i16(words), emits.to(torch.uint8), _to_i32(x)


def frozen_encode_lanes_plain(syms: torch.Tensor, cgrid: torch.Tensor,
                              packed: torch.Tensor, model):
    T = syms.shape[0]
    valid, aux = device_aux_plain(T, cgrid)
    ctx = model.context_grids(syms, aux)
    v = _u32(packed)[ctx * model.alphabet + syms.long()]
    start = torch.where(valid, v & 0xFFFF, 0)
    freq = torch.where(valid, (v >> 16) - (v & 0xFFFF), 1)
    return pass2_plain(start, freq, valid)


def frozen_encode_lanes(syms: torch.Tensor, cgrid: torch.Tensor,
                        packed: torch.Tensor, model):
    """(T, L) uint8 symbols, (J, L) int32 read lengths, packed table ->
    ((T, L) int16 words, (T, L) uint8 emit, (L,) int32 final states)."""
    if not _on_card(syms, cgrid, packed):
        return frozen_encode_lanes_plain(syms, cgrid, packed, model)
    _check(syms, "syms", torch.uint8, 2)
    _check(cgrid, "cgrid", torch.int32, 2)
    _check(packed, "packed", torch.int32, 1)
    T, L = syms.shape
    J = cgrid.shape[0]
    if cgrid.shape[1] != L or packed.numel() != model.n_ctx * model.alphabet:
        raise ValueError("frozen_encode_lanes: shape mismatch")
    dev = syms.device
    lib = _lib()
    scratch = _chunk_scratch(lib, T, L, dev)
    sf = torch.empty((T, L), dtype=torch.int64, device=dev)   # sf, recip
    words = torch.empty((T, L), dtype=torch.int16, device=dev)
    emit = torch.empty((T, L), dtype=torch.uint8, device=dev)
    states = torch.empty((L,), dtype=torch.int32, device=dev)
    _launch(lib.fq_frozen_encode_lanes, "frozen_encode_lanes", dev,
            _ptr(syms), _ptr(cgrid), J, T, L, _ptr(packed), packed.numel(),
            model.alphabet, *_spec_args(model), _ptr(scratch), _ptr(sf),
            _ptr(words), _ptr(emit), _ptr(states))
    return words, emit, states


# --- K3 -----------------------------------------------------------------

def compact_words_plain(words: torch.Tensor, emit: torch.Tensor):
    e = emit.reshape(-1).bool()
    n = e.numel()
    idx = torch.cumsum(e.long(), dim=0) - 1
    out = torch.zeros((n,), dtype=torch.int16, device=words.device)
    out[idx[e]] = words.reshape(-1)[e]
    return out, e.sum().to(torch.int32).reshape(1)


def compact_words(words: torch.Tensor, emit: torch.Tensor):
    """(T, L) int16 words + uint8 emit flags -> ((T*L,) int16 with the
    emitted words as a dense prefix in (wave, lane) order, (1,) int32
    count)."""
    if not _on_card(words, emit):
        return compact_words_plain(words, emit)
    _check(words, "words", torch.int16, 2)
    _check(emit, "emit", torch.uint8, 2)
    if words.shape != emit.shape:
        raise ValueError("compact_words: shape mismatch")
    n = words.numel()
    if n >= 1 << 31:
        raise ValueError(f"compact_words: {n} slots, the kernel takes fewer "
                         f"than 2^31")
    dev = words.device
    lib = _lib()
    nbytes = lib.fq_compact_words_scratch_bytes(n)
    scratch = torch.empty(((nbytes + 7) // 8,), dtype=torch.int64, device=dev)
    out = torch.empty((n,), dtype=torch.int16, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    _launch(lib.fq_compact_words, "compact_words", dev, _ptr(words),
            _ptr(emit), n, _ptr(scratch), _ptr(out), _ptr(count))
    return out, count


# --- K4 -----------------------------------------------------------------

def frozen_decode_plain(states0: torch.Tensor, words: torch.Tensor,
                        cgrid: torch.Tensor, T: int, cum: torch.Tensor,
                        model) -> torch.Tensor:
    """Wave loop of engine._decode_frozen (binary-search variant)."""
    L = states0.shape[0]
    A = model.alphabet
    dev = states0.device
    valid, aux = device_aux_plain(T, cgrid)
    F = _u16(cum).reshape(-1)
    W = words.shape[0]
    w16 = _u16(words)
    st = model.lane_init(L, dev)
    x = _u32(states0)
    off = 0
    steps = max(1, (A - 1).bit_length())
    out = torch.zeros((T, L), dtype=torch.uint8, device=dev)
    for t in range(T):
        vld = valid[t]
        aux_t = {"start": aux["start"][t], "pos": aux["pos"][t]}
        base = model.context(st, aux_t) * (A + 1)
        low = x & (RANS_M - 1)
        lo = torch.zeros_like(low)
        hi = torch.full_like(low, A - 1)
        for _ in range(steps):
            mid = (lo + hi + 1) >> 1
            le = F[base + mid] <= low
            lo = torch.where(le, mid, lo)
            hi = torch.where(le, hi, mid - 1)
        start = F[base + lo]
        f = F[base + lo + 1] - start
        xn = (f * (x >> PROB_BITS) + low - start) & 0xFFFFFFFF
        need = (xn < RANS_L) & vld
        rank = torch.cumsum(need.long(), dim=0) - need.long()
        wv = w16[torch.clamp(off + rank, max=W - 1)]
        xn = torch.where(need, ((xn << 16) | wv) & 0xFFFFFFFF, xn)
        x = torch.where(vld, xn, x)
        off += int(need.sum())
        out[t] = torch.where(vld, lo, 0).to(torch.uint8)
        new = model.update(st, lo, aux_t)
        st = {k: torch.where(vld, new[k], st[k]) for k in st}
    return out


def frozen_decode(states0: torch.Tensor, words: torch.Tensor,
                  cgrid: torch.Tensor, T: int, cum: torch.Tensor,
                  model) -> torch.Tensor:
    """(L,) int32 initial states, (W,) int16 padded words, (J, L) int32
    read lengths, (n_ctx, A+1) int16 cum table -> (T, L) uint8 symbols
    (0 at padding)."""
    if not _on_card(states0, words, cgrid, cum):
        return frozen_decode_plain(states0, words, cgrid, T, cum, model)
    _check(states0, "states0", torch.int32, 1)
    _check(words, "words", torch.int16, 1)
    _check(cgrid, "cgrid", torch.int32, 2)
    _check(cum, "cum", torch.int16, 2)
    L = states0.shape[0]
    A = model.alphabet
    if (cgrid.shape[1] != L or tuple(cum.shape) != (model.n_ctx, A + 1)
            or words.numel() < 1):
        raise ValueError("frozen_decode: shape mismatch")
    lib = _lib()
    dev = states0.device
    lanes = torch.empty((L * lib.fq_decode_lane_bytes(),), dtype=torch.uint8,
                        device=dev)
    out = torch.empty((T, L), dtype=torch.uint8, device=dev)
    _launch(lib.fq_frozen_decode, "frozen_decode", dev, _ptr(states0),
            _ptr(words), words.numel(), _ptr(cgrid), cgrid.shape[0], T, L,
            _ptr(cum), A, *_spec_args(model), _ptr(lanes), _ptr(out))
    return out


def _cluster_shape(fn, name: str, L: int, model, device) -> Dict[str, int]:
    """A decoder's thread-block cluster for L lanes on ``device`` (a CUDA
    device; default the current one): CTAs in the cluster, threads a CTA,
    lanes a thread, and how many such clusters the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    out = (ctypes.c_int32 * 4)()
    with torch.cuda.device(device):
        rc = fn(L, model.spec()[0], out)
    if rc != 0:
        raise RuntimeError(f"{name}: cudaError_t {rc}")
    return {"ctas": out[0], "threads": out[1], "lanes_per_thread": out[2],
            "max_active_clusters": out[3]}


def frozen_decode_shape(L: int, model, device=None) -> Dict[str, int]:
    """The thread-block cluster K4 launches for L lanes (_cluster_shape)."""
    return _cluster_shape(_lib().fq_frozen_decode_shape,
                          "frozen_decode_shape", L, model, device)


# --- transfer packs: K15 unpack_grid, K16 pack_grid, K17 pack15 ------------
#
# Modes (engine._pack_mode, _pack_for_upload): 2, 4, 6 bits a symbol, four
# symbols a group (L % 4 == 0); 15 = mode-4 nibbles and 23 = mode-2 codes
# whose sentinel (15, 3) takes the next value of the exception list in a
# sidecar [perm (16 B) | exceptions], every other code c the symbol
# side[c].

PACK_BITS = {2: 2, 4: 4, 6: 6, 15: 4, 23: 2}
_SENT = {15: 15, 23: 3}
EXC_SYM = 15                 # K17's sentinel nibble


def packed_width(mode: int, L: int) -> int:
    """Bytes a packed row of L symbols takes in ``mode``."""
    return L * PACK_BITS[mode] // 8


def _unpack_dense(packed: torch.Tensor, bits: int) -> torch.Tensor:
    T, W = packed.shape
    p = packed.long()
    if bits == 2:
        parts = [(p >> s) & 3 for s in (0, 2, 4, 6)]
    elif bits == 4:
        parts = [p & 15, p >> 4]
    else:
        p3 = p.reshape(T, W // 3, 3)
        v = p3[:, :, 0] | (p3[:, :, 1] << 8) | (p3[:, :, 2] << 16)
        parts = [(v >> s) & 63 for s in (0, 6, 12, 18)]
    return torch.stack(parts, dim=2).reshape(T, W * 8 // bits).to(torch.uint8)


def _unpack_sent_plain(flat: torch.Tensor, side: torch.Tensor,
                       sent: int) -> torch.Tensor:
    """engine._unpack_sent_dev: the k-th sentinel in scan order takes
    side[16 + clip(k, 0, len(side) - 17)], any other code c side[c]."""
    mask = flat == sent
    idx = torch.cumsum(mask.long(), dim=0) - 1
    vals = side[16 + torch.clamp(idx, 0, side.numel() - 17)]
    top = side[torch.clamp(flat.long(), max=sent)]
    return torch.where(mask, vals, top)


def unpack_grid_plain(packed: torch.Tensor, mode: int,
                      side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, packed_width) uint8 -> (T, L) uint8 symbols."""
    grid = _unpack_dense(packed, PACK_BITS[mode])
    if mode not in _SENT:
        return grid
    return _unpack_sent_plain(grid.reshape(-1), side, _SENT[mode]).reshape(
        grid.shape)


def unpack_grid(packed: torch.Tensor, mode: int,
                side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K15: a packed (T, packed_width(mode, L)) uint8 grid (and, in modes
    15 and 23, the (16 + n,) uint8 sidecar) -> the (T, L) uint8 symbol
    grid."""
    if mode not in PACK_BITS:
        raise ValueError(f"unpack_grid: no pack mode {mode}")
    if (side is None) != (mode not in _SENT):
        raise ValueError(f"unpack_grid: mode {mode} takes "
                         f"{'a' if mode in _SENT else 'no'} sidecar")
    if not _on_card(packed, *([] if side is None else [side])):
        return unpack_grid_plain(packed, mode, side)
    _check(packed, "packed", torch.uint8, 2)
    if side is not None:
        _check(side, "side", torch.uint8, 1)
        if side.numel() < 17:
            raise ValueError("unpack_grid: the sidecar holds no exception "
                             "slot")
    T, W = packed.shape
    L = W * 8 // PACK_BITS[mode]
    if L % 4 or packed_width(mode, L) != W:
        raise ValueError(f"unpack_grid: width {W} is no mode-{mode} row of "
                         f"whole 4-symbol groups")
    if mode in _SENT and T * L >= 1 << 31:
        raise ValueError(f"unpack_grid: {T * L} slots, the sentinel modes "
                         f"take fewer than 2^31")
    dev = packed.device
    lib = _lib()
    grid = torch.empty((T, L), dtype=torch.uint8, device=dev)
    nbytes = lib.fq_unpack_grid_scratch_bytes(mode, T * L)
    scratch = (torch.empty(((nbytes + 7) // 8,), dtype=torch.int64,
                           device=dev) if nbytes else None)
    _launch(lib.fq_unpack_grid, "unpack_grid", dev, _ptr(packed), mode, T, L,
            None if side is None else _ptr(side),
            0 if side is None else side.numel(),
            None if scratch is None else _ptr(scratch), packed.numel(),
            _ptr(grid))
    UNPACK_MODES[mode] += 1
    return grid


def pack_grid_plain(grid: torch.Tensor, mode: int) -> torch.Tensor:
    T, L = grid.shape
    g = grid.long()
    if mode == 4:
        g = g.reshape(T, L // 2, 2)
        return (g[:, :, 0] | (g[:, :, 1] << 4)).to(torch.uint8)
    g = g.reshape(T, L // 4, 4)
    if mode == 2:
        return (g[:, :, 0] | (g[:, :, 1] << 2) | (g[:, :, 2] << 4)
                | (g[:, :, 3] << 6)).to(torch.uint8)
    v = g[:, :, 0] | (g[:, :, 1] << 6) | (g[:, :, 2] << 12) | (g[:, :, 3] << 18)
    out = torch.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], dim=2)
    return out.to(torch.uint8).reshape(T, (L // 4) * 3)


def pack_grid(grid: torch.Tensor, mode: int) -> torch.Tensor:
    """K16: (T, L) uint8 symbols -> (T, packed_width) uint8, mode 2, 4
    or 6 (the reference's unmasked ORs: a symbol at or above 2^bits packs
    as pack_grid_plain packs it)."""
    if not _on_card(grid):
        return pack_grid_plain(grid, mode)
    if mode not in (2, 4, 6):
        raise ValueError(f"pack_grid: no dense pack mode {mode}")
    _check(grid, "grid", torch.uint8, 2)
    T, L = grid.shape
    if L % 4:
        raise ValueError(f"pack_grid: L = {L} is not a multiple of 4")
    out = torch.empty((T, packed_width(mode, L)), dtype=torch.uint8,
                      device=grid.device)
    _launch(_lib().fq_pack_grid, "pack_grid", grid.device, _ptr(grid), mode,
            T, L, _ptr(out))
    return out


def pack15_plain(syms: torch.Tensor, cgrid: torch.Tensor):
    """engine._pack15_dev, validity from the (J, L) read lengths."""
    T, L = syms.shape
    dev = syms.device
    valid = (torch.arange(T, device=dev)[:, None]
             < cgrid.long().sum(dim=0)[None, :])
    keep = (valid & (syms < 64)).reshape(-1)
    hist = torch.zeros(64, dtype=torch.int64, device=dev)
    hist.index_add_(0, syms.reshape(-1).long()[keep],
                    torch.ones_like(syms.reshape(-1)[keep], dtype=torch.int64))
    # lax.top_k order: count descending, ties to the lower symbol
    top = torch.sort(hist, descending=True, stable=True).indices[:EXC_SYM]
    filled = torch.where(valid, syms, top[0].to(torch.uint8))
    lut = torch.full((64,), EXC_SYM, dtype=torch.uint8, device=dev)
    lut[top] = torch.arange(EXC_SYM, dtype=torch.uint8, device=dev)
    nib = lut[torch.clamp(filled.long(), max=63)]
    mask = nib.reshape(-1) == EXC_SYM
    cap = syms.numel() // 4
    exc = filled.reshape(-1)[mask][:cap]
    side = torch.zeros(16 + cap, dtype=torch.uint8, device=dev)
    side[:EXC_SYM] = top.to(torch.uint8)
    side[16:16 + exc.numel()] = exc
    return (pack_grid_plain(nib, 4), side,
            mask.sum().to(torch.int32).reshape(1))


def pack15(syms: torch.Tensor, cgrid: torch.Tensor):
    """K17: a decoded (T, L) uint8 6-bit grid and its (J, L) int32 read
    lengths -> ((T, L/2) uint8 nibbles, (16 + T*L/4,) uint8 sidecar
    [top 15 | exceptions below the cap], (1,) int32 exception count,
    those past the cap included)."""
    if not _on_card(syms, cgrid):
        return pack15_plain(syms, cgrid)
    _check(syms, "syms", torch.uint8, 2)
    _check(cgrid, "cgrid", torch.int32, 2)
    T, L = syms.shape
    J = cgrid.shape[0]
    if cgrid.shape[1] != L or L % 4:
        raise ValueError("pack15: shape mismatch")
    if syms.data_ptr() % 16:
        raise ValueError("pack15: the grid must start 16-byte aligned")
    lib = _lib()
    dev = syms.device
    cap = T * L // 4
    scratch = torch.empty((lib.fq_pack15_scratch_bytes(T, L),),
                          dtype=torch.uint8, device=dev)
    nib = torch.empty((T, L // 2), dtype=torch.uint8, device=dev)
    side = torch.zeros((16 + cap,), dtype=torch.uint8, device=dev)
    n_exc = torch.empty((1,), dtype=torch.int32, device=dev)
    _launch(lib.fq_pack15, "pack15", dev, _ptr(syms), _ptr(cgrid), J, T, L,
            _ptr(scratch), _ptr(nib), _ptr(side), _ptr(n_exc), cap)
    return nib, side, n_exc


# --- adaptive coder: K5, K7, K6 ---------------------------------------------

def check_adapt_model(model, counts0=None) -> None:
    """The adaptive kernels skip padding lanes, which is exact only while
    every count row starts at or under cap (the reference halves the rows
    of padding lanes' contexts too): a fresh table needs init * A <= cap,
    a caller's table (counts0) every row total <= cap."""
    if counts0 is None:
        if model.init * model.alphabet > model.cap:
            raise ValueError(
                f"adaptive coder: init * alphabet = {model.init} * "
                f"{model.alphabet} > cap = {model.cap}; the adaptive kernels "
                f"need every count row to start at or under cap")
        return
    _check_table(counts0, model)
    top = int(counts0.long().sum(dim=1).max()) if counts0.numel() else 0
    if top > model.cap:
        raise ValueError(
            f"adaptive coder: a counts0 row totals {top} > cap = "
            f"{model.cap}; the adaptive kernels need every count row to "
            f"start at or under cap")


def _check_table(counts0: torch.Tensor, model) -> None:
    if (counts0.dtype != torch.int32 or counts0.dim() != 2
            or tuple(counts0.shape) != (model.n_ctx, model.alphabet)):
        raise ValueError(f"counts0: want int32 ({model.n_ctx}, "
                         f"{model.alphabet}), got {counts0.dtype} "
                         f"{tuple(counts0.shape)}")


def _start_counts(model, dev, counts0=None) -> torch.Tensor:
    """The walk's starting (n_ctx, A) int32 counts: init everywhere, or a
    copy of counts0 (the kernels update it in place)."""
    if counts0 is None:
        return torch.full((model.n_ctx, model.alphabet), model.init,
                          dtype=torch.int32, device=dev)
    return counts0.to(device=dev, dtype=torch.int32,
                      memory_format=torch.contiguous_format).clone()


def _adapt_table(model, dev, counts0=None):
    """(counts, row totals) for K6's walk, from a fresh table or from
    counts0."""
    counts = _start_counts(model, dev, counts0)
    return counts, counts.sum(dim=1, dtype=torch.int32)


def _check_adapt_card(model, T: int, L: int, name: str) -> None:
    """What K5 and K6 index in 32 bits: table rows, the (T, L) slots, and
    symbols below 256."""
    if model.n_ctx >= 1 << 32 or T * L >= 1 << 31 or model.alphabet > 256:
        raise ValueError(f"{name}: the card's adaptive kernels take n_ctx < "
                         f"2^32, T * L < 2^31 and alphabet <= 256 (got "
                         f"{model.n_ctx}, {T} * {L}, {model.alphabet})")


def _quant_rows(rows: torch.Tensor) -> torch.Tensor:
    """(n, A) counts -> (n, A+1) int64 F with F_s = floor(cum_s * M / C)
    (engine._quant, whose two 7-bit digits compute the same floor)."""
    cs = torch.cumsum(rows.long(), dim=1)
    F = (cs * RANS_M) // cs[:, -1:]
    return torch.cat([torch.zeros_like(F[:, :1]), F], dim=1)


def _wave_update(counts: torch.Tensor, ctx, sym, inc, model,
                 n_halve: int) -> None:
    """engine._wave_update_tot in place: scatter-add inc at (ctx, sym),
    then halve the rows of every lane's context (padding lanes included,
    as the reference does) n_halve times while over cap."""
    counts.index_put_((ctx, sym), inc, accumulate=True)
    rows = counts[ctx]
    for _ in range(n_halve):
        tot = rows.sum(dim=1, keepdim=True)
        rows = torch.where(tot > model.cap, (rows + 1) >> 1, rows)
    counts[ctx] = rows


def _walk_aux(T: int, cgrid: torch.Tensor, ctxg):
    valid, aux = device_aux_plain(T, cgrid)
    if ctxg is not None:
        aux["ctx"] = ctxg
    return valid, aux


def adapt_encode_walk_plain(syms: torch.Tensor, cgrid: torch.Tensor, model,
                            n_halve: int, ctxg=None,
                            counts0=None) -> torch.Tensor:
    """Wave loop of engine._pass1 over model.context_grids: (start, end)
    of each symbol from the pre-update row, packed as start | end << 16
    (0 at padding)."""
    T, L = syms.shape
    valid, aux = _walk_aux(T, cgrid, ctxg)
    ctx = model.context_grids(syms, aux)
    s = syms.long()
    inc = torch.where(valid, model.inc, 0).to(torch.int32)
    counts = _start_counts(model, syms.device, counts0)
    sf = torch.zeros((T, L), dtype=torch.int64, device=syms.device)
    for t in range(T):
        F = _quant_rows(counts[ctx[t]])
        st = F.gather(1, s[t, :, None])[:, 0]
        en = F.gather(1, s[t, :, None] + 1)[:, 0]
        sf[t] = torch.where(valid[t], st | (en << 16), 0)
        _wave_update(counts, ctx[t], s[t], inc[t], model, n_halve)
    return _to_i32(sf)


def adapt_encode_walk(syms: torch.Tensor, cgrid: torch.Tensor, model,
                      n_halve: int, ctxg=None, counts0=None) -> torch.Tensor:
    """(T, L) uint8 symbols, (J, L) int32 read lengths [, (T, L) int32
    contexts for FlatModel] -> (T, L) int32 packed start | end << 16 from
    a fresh adaptive table (init everywhere) or from a copy of counts0,
    (n_ctx, A) int32 with every row at or under cap."""
    check_adapt_model(model, counts0)
    kind = model.spec()[0]
    if (kind == 4) != (ctxg is not None):
        raise ValueError("adapt_encode_walk: a ctx grid goes with FlatModel "
                         "(kind 4) only")
    grids = ((syms, cgrid) + (() if ctxg is None else (ctxg,))
             + (() if counts0 is None else (counts0,)))
    if not _on_card(*grids):
        return adapt_encode_walk_plain(syms, cgrid, model, n_halve, ctxg,
                                       counts0)
    _check(syms, "syms", torch.uint8, 2)
    _check(cgrid, "cgrid", torch.int32, 2)
    T, L = syms.shape
    if cgrid.shape[1] != L:
        raise ValueError("adapt_encode_walk: shape mismatch")
    if ctxg is not None:
        _check(ctxg, "ctxg", torch.int32, 2)
        if ctxg.shape != syms.shape:
            raise ValueError("adapt_encode_walk: ctx grid shape mismatch")
    _check_adapt_card(model, T, L, "adapt_encode_walk")
    lib = _lib()
    dev = syms.device
    c0 = None if counts0 is None else counts0.contiguous()
    scratch = torch.empty(
        (lib.fq_adapt_encode_scratch_bytes(T, L, model.n_ctx),),
        dtype=torch.uint8, device=dev)
    sf = torch.empty((T, L), dtype=torch.int32, device=dev)
    _launch(lib.fq_adapt_encode_walk, "adapt_encode_walk", dev, _ptr(syms),
            _ptr(cgrid), cgrid.shape[0], T, L,
            None if ctxg is None else _ptr(ctxg), model.alphabet,
            *_spec_args(model), model.inc, model.cap, n_halve, model.init,
            None if c0 is None else _ptr(c0), model.n_ctx, _ptr(scratch),
            _ptr(sf))
    return sf


def rans_encode_sf_plain(sf: torch.Tensor, cgrid: torch.Tensor):
    valid, _ = device_aux_plain(sf.shape[0], cgrid)
    v = _u32(sf)
    start = v & 0xFFFF
    return pass2_plain(start, (v >> 16) - start, valid)


def rans_encode_sf(sf: torch.Tensor, cgrid: torch.Tensor):
    """(T, L) int32 packed start | end << 16, (J, L) int32 read lengths
    -> ((T, L) int16 words, (T, L) uint8 emit, (L,) int32 final states),
    as frozen_encode_lanes returns them."""
    if not _on_card(sf, cgrid):
        return rans_encode_sf_plain(sf, cgrid)
    _check(sf, "sf", torch.int32, 2)
    _check(cgrid, "cgrid", torch.int32, 2)
    T, L = sf.shape
    if cgrid.shape[1] != L:
        raise ValueError("rans_encode_sf: shape mismatch")
    dev = sf.device
    lib = _lib()
    recip = torch.empty((lib.fq_rans_encode_sf_scratch_bytes() // 4,),
                        dtype=torch.int32, device=dev)
    words = torch.empty((T, L), dtype=torch.int16, device=dev)
    emit = torch.empty((T, L), dtype=torch.uint8, device=dev)
    states = torch.empty((L,), dtype=torch.int32, device=dev)
    _launch(lib.fq_rans_encode_sf, "rans_encode_sf", dev, _ptr(sf),
            _ptr(cgrid), cgrid.shape[0], T, L, _ptr(recip), _ptr(words),
            _ptr(emit), _ptr(states))
    return words, emit, states


def adapt_decode_plain(states0: torch.Tensor, words: torch.Tensor,
                       cgrid: torch.Tensor, T: int, model, n_halve: int,
                       ctxg=None, counts0=None) -> torch.Tensor:
    """Wave loop of engine._decode: sym = #{s >= 1: F[s] <= low} from the
    pre-update row, the rANS decode and renorm scan, the table update."""
    L = states0.shape[0]
    dev = states0.device
    valid, aux = _walk_aux(T, cgrid, ctxg)
    inc = torch.where(valid, model.inc, 0).to(torch.int32)
    counts = _start_counts(model, dev, counts0)
    W = words.shape[0]
    w16 = _u16(words)
    st = model.lane_init(L, dev)
    x = _u32(states0)
    off = 0
    out = torch.zeros((T, L), dtype=torch.uint8, device=dev)
    for t in range(T):
        vld = valid[t]
        aux_t = {k: v[t] for k, v in aux.items()}
        ctx = model.context(st, aux_t)
        F = _quant_rows(counts[ctx])
        low = x & (RANS_M - 1)
        sym = (F[:, 1:] <= low[:, None]).sum(dim=1)
        start = F.gather(1, sym[:, None])[:, 0]
        f = F.gather(1, sym[:, None] + 1)[:, 0] - start
        xn = (f * (x >> PROB_BITS) + low - start) & 0xFFFFFFFF
        need = (xn < RANS_L) & vld
        rank = torch.cumsum(need.long(), dim=0) - need.long()
        wv = w16[torch.clamp(off + rank, max=W - 1)]
        xn = torch.where(need, ((xn << 16) | wv) & 0xFFFFFFFF, xn)
        x = torch.where(vld, xn, x)
        off += int(need.sum())
        out[t] = torch.where(vld, sym, 0).to(torch.uint8)
        _wave_update(counts, ctx, sym, inc[t], model, n_halve)
        new = model.update(st, sym, aux_t)
        st = {k: torch.where(vld, new[k], st[k]) for k in st}
    return out


def adapt_decode(states0: torch.Tensor, words: torch.Tensor,
                 cgrid: torch.Tensor, T: int, model, n_halve: int,
                 ctxg=None, counts0=None) -> torch.Tensor:
    """(L,) int32 initial states, (W,) int16 padded words, (J, L) int32
    read lengths [, (T, L) int32 contexts for FlatModel] -> (T, L) uint8
    symbols (0 at padding), from a fresh adaptive table or from a copy of
    counts0 (as adapt_encode_walk)."""
    check_adapt_model(model, counts0)
    kind = model.spec()[0]
    if (kind == 4) != (ctxg is not None):
        raise ValueError("adapt_decode: a ctx grid goes with FlatModel "
                         "(kind 4) only")
    grids = ((states0, words, cgrid) + (() if ctxg is None else (ctxg,))
             + (() if counts0 is None else (counts0,)))
    if not _on_card(*grids):
        return adapt_decode_plain(states0, words, cgrid, T, model, n_halve,
                                  ctxg, counts0)
    _check(states0, "states0", torch.int32, 1)
    _check(words, "words", torch.int16, 1)
    _check(cgrid, "cgrid", torch.int32, 2)
    L = states0.shape[0]
    if cgrid.shape[1] != L or words.numel() < 1:
        raise ValueError("adapt_decode: shape mismatch")
    if ctxg is not None:
        _check(ctxg, "ctxg", torch.int32, 2)
        if tuple(ctxg.shape) != (T, L):
            raise ValueError("adapt_decode: ctx grid shape mismatch")
    _check_adapt_card(model, T, L, "adapt_decode")
    lib = _lib()
    dev = states0.device
    counts, tot = _adapt_table(model, dev, counts0)
    scratch = torch.empty(
        (lib.fq_adapt_decode_scratch_bytes(L, model.n_ctx, model.alphabet),),
        dtype=torch.uint8, device=dev)
    out = torch.empty((T, L), dtype=torch.uint8, device=dev)
    _launch(lib.fq_adapt_decode, "adapt_decode", dev, _ptr(states0),
            _ptr(words), words.numel(), _ptr(cgrid), cgrid.shape[0], T, L,
            None if ctxg is None else _ptr(ctxg), model.alphabet,
            *_spec_args(model), model.inc, model.cap, n_halve,
            _ptr(counts), _ptr(tot), model.n_ctx, _ptr(scratch), _ptr(out))
    return out


def adapt_decode_shape(L: int, model, device=None) -> Dict[str, int]:
    """The thread-block cluster K6 launches for L lanes (_cluster_shape)."""
    return _cluster_shape(_lib().fq_adapt_decode_shape, "adapt_decode_shape",
                          L, model, device)


# --- semi-adaptive walk: K11, K12; trainer: K13 -----------------------------

def _halve_rows(rows: torch.Tensor, cap: int, n: int) -> torch.Tensor:
    """engine._rescale_full on some rows: halve ((c + 1) >> 1) wherever the
    row total is over cap, n times."""
    for _ in range(n):
        tot = rows.sum(dim=1, keepdim=True)
        rows = torch.where(tot > cap, (rows + 1) >> 1, rows)
    return rows


def _snapshot(counts: torch.Tensor) -> torch.Tensor:
    """(n, A) counts -> (n, A) int64 snapshot F[s] | F[s+1] << 16 (the
    words K1 packs; engine._snapshot_sf packs start | freq << 16 over the
    same F)."""
    return _u32(quant_pack_plain(counts)[1]).reshape(counts.shape)


class _SemiTable:
    """The semi-adaptive walk's count table and snapshot.  A chunk
    boundary halves and re-snapshots only the rows the chunk touched and
    the rows still over cap: every other row is at or under cap and
    unchanged, where the reference's whole-table pass is a no-op."""

    def __init__(self, model, dev, counts0):
        self.cap, self.inc = model.cap, model.inc
        self.counts = _start_counts(model, dev, counts0)
        self.snap = _snapshot(self.counts)
        self.over = self.counts.long().sum(dim=1) > self.cap
        self.touched = []

    def add(self, ctx: torch.Tensor, sym: torch.Tensor) -> None:
        """inc at each (ctx, sym) of the chunk's valid slots."""
        self.counts.index_put_(
            (ctx, sym), torch.full_like(ctx, self.inc, dtype=torch.int32),
            accumulate=True)
        self.touched.append(ctx)

    def boundary(self, n_halve: int, snapshot: bool = True) -> None:
        rows = torch.unique(torch.cat(self.touched + [
            self.over.nonzero()[:, 0]]))
        self.touched = []
        r = _halve_rows(self.counts[rows], self.cap, n_halve)
        self.counts[rows] = r
        self.over[rows] = r.long().sum(dim=1) > self.cap
        if snapshot:
            self.snap[rows] = _snapshot(r)


def semi_encode_walk_plain(syms: torch.Tensor, cgrid: torch.Tensor, model,
                           n_halve: int, chunk: int, counts0=None):
    """engine._pass1_semi, a chunk at a time: (T, L) int32 start | end
    << 16 (0 at padding) and the final (n_ctx, A) int32 counts."""
    T, L = syms.shape
    valid, aux = device_aux_plain(T, cgrid)
    ctx = model.context_grids(syms, aux).long()
    s = syms.long()
    tab = _SemiTable(model, syms.device, counts0)
    sf = torch.zeros((T, L), dtype=torch.int64, device=syms.device)
    for t0 in range(0, T, chunk):
        if t0:
            tab.boundary(n_halve)
        v = valid[t0:t0 + chunk]
        cx, sx = ctx[t0:t0 + chunk][v], s[t0:t0 + chunk][v]
        part = torch.zeros_like(sf[t0:t0 + chunk])
        part[v] = tab.snap[cx, sx]
        sf[t0:t0 + chunk] = part
        tab.add(cx, sx)
    if T:           # no chunk, no halving (the reference scans no chunks)
        tab.boundary(n_halve, snapshot=False)
    return _to_i32(sf), tab.counts


def _semi_checks(name: str, model, T: int, chunk: int, counts0) -> None:
    if model.spec()[0] == 4:
        raise ValueError(f"{name}: the semi-adaptive walk takes models "
                         f"that compute their contexts (kinds 0-3)")
    if chunk <= 0 or T % chunk:
        raise ValueError(f"{name}: chunk {chunk} must divide T = {T}")
    if counts0 is not None:
        _check_table(counts0, model)


def semi_encode_walk(syms: torch.Tensor, cgrid: torch.Tensor, model,
                     n_halve: int, chunk: int, counts0=None):
    """K11: (T, L) uint8 symbols, (J, L) int32 read lengths -> ((T, L)
    int32 packed start | end << 16, 0 at padding, as K7 reads it; the
    final (n_ctx, A) int32 counts), the table starting as init everywhere
    or as a copy of counts0 and snapshotted every ``chunk`` waves (chunk
    divides T), halved up to n_halve times at each chunk boundary."""
    T, L = syms.shape
    _semi_checks("semi_encode_walk", model, T, chunk, counts0)
    grids = (syms, cgrid) + (() if counts0 is None else (counts0,))
    if not _on_card(*grids):
        return semi_encode_walk_plain(syms, cgrid, model, n_halve, chunk,
                                      counts0)
    _check(syms, "syms", torch.uint8, 2)
    _check(cgrid, "cgrid", torch.int32, 2)
    if cgrid.shape[1] != L:
        raise ValueError("semi_encode_walk: shape mismatch")
    lib = _lib()
    dev = syms.device
    counts = _start_counts(model, dev, counts0)
    snap = torch.empty((counts.numel(),), dtype=torch.int32, device=dev)
    ctxg = torch.empty((T, L), dtype=torch.int32, device=dev)
    scratch = torch.empty(
        (lib.fq_semi_encode_scratch_bytes(T, L, model.n_ctx),),
        dtype=torch.uint8, device=dev)
    sf = torch.empty((T, L), dtype=torch.int32, device=dev)
    _launch(lib.fq_semi_encode_walk, "semi_encode_walk", dev, _ptr(syms),
            _ptr(cgrid), cgrid.shape[0], T, L, model.alphabet,
            *_spec_args(model), model.n_ctx, model.inc, model.cap, n_halve,
            chunk, _ptr(counts), _ptr(snap), _ptr(ctxg), _ptr(scratch),
            _ptr(sf))
    return sf, counts


def _search_steps(A: int) -> int:
    """engine._decode_semi's binary-search step count, ceil(log2 A) but
    at least 1."""
    return max(1, (A - 1).bit_length())


def semi_decode_plain(states0: torch.Tensor, words: torch.Tensor,
                      cgrid: torch.Tensor, T: int, model, n_halve: int,
                      chunk: int, counts0=None):
    """Wave loop of engine._decode_semi: the binary search over the
    snapshot's low halves, the rANS decode and renorm scan, the count
    update; the table pass at each chunk boundary.  Returns ((T, L) uint8
    symbols, final counts)."""
    L = states0.shape[0]
    A = model.alphabet
    dev = states0.device
    valid, aux = device_aux_plain(T, cgrid)
    tab = _SemiTable(model, dev, counts0)
    W = words.shape[0]
    w16 = _u16(words)
    st = model.lane_init(L, dev)
    x = _u32(states0)
    off = 0
    steps = _search_steps(A)
    out = torch.zeros((T, L), dtype=torch.uint8, device=dev)
    for t in range(T):
        if t and t % chunk == 0:
            tab.boundary(n_halve)
        vld = valid[t]
        aux_t = {k: v[t] for k, v in aux.items()}
        base = model.context(st, aux_t).long() * A
        sv = tab.snap.reshape(-1)
        low = x & (RANS_M - 1)
        lo = torch.zeros_like(low)
        hi = torch.full_like(low, A - 1)
        for _ in range(steps):
            mid = (lo + hi + 1) >> 1
            le = (sv[base + mid] & 0xFFFF) <= low
            lo = torch.where(le, mid, lo)
            hi = torch.where(le, hi, mid - 1)
        v = sv[base + lo]
        start = v & 0xFFFF
        f = (v >> 16) - start
        xn = (f * (x >> PROB_BITS) + low - start) & 0xFFFFFFFF
        need = (xn < RANS_L) & vld
        rank = torch.cumsum(need.long(), dim=0) - need.long()
        wv = w16[torch.clamp(off + rank, max=W - 1)]
        xn = torch.where(need, ((xn << 16) | wv) & 0xFFFFFFFF, xn)
        x = torch.where(vld, xn, x)
        off += int(need.sum())
        out[t] = torch.where(vld, lo, 0).to(torch.uint8)
        tab.add((base // A)[vld], lo[vld])
        new = model.update(st, lo, aux_t)
        st = {k: torch.where(vld, new[k], st[k]) for k in st}
    if T:
        tab.boundary(n_halve, snapshot=False)
    return out, tab.counts


def semi_decode(states0: torch.Tensor, words: torch.Tensor,
                cgrid: torch.Tensor, T: int, model, n_halve: int, chunk: int,
                counts0=None):
    """K12: (L,) int32 initial states, (W,) int16 padded words, (J, L)
    int32 read lengths -> ((T, L) uint8 symbols, 0 at padding; the final
    (n_ctx, A) int32 counts), the inverse of semi_encode_walk + K7."""
    _semi_checks("semi_decode", model, T, chunk, counts0)
    grids = (states0, words, cgrid) + (() if counts0 is None
                                       else (counts0,))
    if not _on_card(*grids):
        return semi_decode_plain(states0, words, cgrid, T, model, n_halve,
                                 chunk, counts0)
    _check(states0, "states0", torch.int32, 1)
    _check(words, "words", torch.int16, 1)
    _check(cgrid, "cgrid", torch.int32, 2)
    L = states0.shape[0]
    if cgrid.shape[1] != L or words.numel() < 1:
        raise ValueError("semi_decode: shape mismatch")
    lib = _lib()
    dev = states0.device
    A = model.alphabet
    counts = _start_counts(model, dev, counts0)
    snap = torch.empty((counts.numel(),), dtype=torch.int32, device=dev)
    scratch = torch.empty(
        (lib.fq_semi_decode_scratch_bytes(L, model.n_ctx, chunk),),
        dtype=torch.uint8, device=dev)
    out = torch.empty((T, L), dtype=torch.uint8, device=dev)
    _launch(lib.fq_semi_decode, "semi_decode", dev, _ptr(states0),
            _ptr(words), words.numel(), _ptr(cgrid), cgrid.shape[0], T, L, A,
            *_spec_args(model), model.n_ctx, model.inc, model.cap, n_halve,
            chunk, _ptr(counts), _ptr(snap), _ptr(scratch), _ptr(out))
    return out, counts


def semi_decode_shape(L: int, model, device=None) -> Dict[str, int]:
    """The thread-block cluster K12 launches for each chunk of a stream of
    L lanes (_cluster_shape)."""
    return _cluster_shape(_lib().fq_semi_decode_shape, "semi_decode_shape",
                          L, model, device)


def train_counts_plain(syms: torch.Tensor, cgrid: torch.Tensor, model,
                       ctxg=None) -> torch.Tensor:
    """engine._train_counts: the (ctx, sym) histogram of the valid slots
    times inc, plus init, then up to 24 halvings of every row over cap
    (K13's two halves, train_hist_plain then train_rows_plain)."""
    counts = torch.zeros((model.n_ctx, model.alphabet), dtype=torch.int32,
                         device=syms.device)
    return train_rows_plain(train_hist_plain(syms, cgrid, model, counts,
                                             ctxg), model)


def train_counts(syms: torch.Tensor, cgrid: torch.Tensor, model,
                 ctxg=None) -> torch.Tensor:
    """K13: (T, L) uint8 symbols, (J, L) int32 read lengths [, (T, L)
    int32 contexts for FlatModel] -> the trained (n_ctx, A) int32 table."""
    kind = model.spec()[0]
    if (kind == 4) != (ctxg is not None):
        raise ValueError("train_counts: a ctx grid goes with FlatModel "
                         "(kind 4) only")
    grids = (syms, cgrid) + (() if ctxg is None else (ctxg,))
    if not _on_card(*grids):
        return train_counts_plain(syms, cgrid, model, ctxg)
    _check(syms, "syms", torch.uint8, 2)
    _check(cgrid, "cgrid", torch.int32, 2)
    T, L = syms.shape
    if cgrid.shape[1] != L:
        raise ValueError("train_counts: shape mismatch")
    if ctxg is not None:
        _check(ctxg, "ctxg", torch.int32, 2)
        if ctxg.shape != syms.shape:
            raise ValueError("train_counts: ctx grid shape mismatch")
    counts = torch.zeros((model.n_ctx, model.alphabet), dtype=torch.int32,
                         device=syms.device)
    lib = _lib()
    scratch = _chunk_scratch(lib, T, L, syms.device)
    _launch(lib.fq_train_counts, "train_counts", syms.device, _ptr(syms),
            _ptr(cgrid), cgrid.shape[0], L,
            None if ctxg is None else _ptr(ctxg), model.alphabet,
            *_spec_args(model), model.n_ctx, model.inc, model.init,
            model.cap, _ptr(counts), T, _ptr(scratch))
    return counts


def _chunk_scratch(lib, T: int, L: int, dev) -> torch.Tensor:
    """The chunk walk's scratch (K13, K2): the lanes' lengths and, per
    (chunk, lane), the read cursor and quality drops at the chunk's
    start."""
    return torch.empty((max(1, lib.fq_chunk_scratch_bytes(T, L)),),
                       dtype=torch.uint8, device=dev)


# --- K13's halves, for the mesh trainer (parallel/mesh.train_counts_sharded)

def train_hist_plain(syms: torch.Tensor, cgrid: torch.Tensor, model,
                     counts: torch.Tensor, ctxg=None) -> torch.Tensor:
    """counts += the (ctx, sym) histogram of the valid slots times inc."""
    valid, aux = _walk_aux(syms.shape[0], cgrid, ctxg)
    ctx = model.context_grids(syms, aux).long()
    n, A = model.n_ctx, model.alphabet
    flat = (ctx * A + syms.long())[valid]
    counts += (torch.bincount(flat, minlength=n * A).reshape(n, A)
               * model.inc).to(torch.int32)
    return counts


def train_hist(syms: torch.Tensor, cgrid: torch.Tensor, model,
               counts: torch.Tensor, ctxg=None) -> torch.Tensor:
    """K13's histogram half: adds inc at (ctx, sym) of every valid slot of
    one (T, L) grid into ``counts`` ((n_ctx, A) int32, in place)."""
    kind = model.spec()[0]
    if (kind == 4) != (ctxg is not None):
        raise ValueError("train_hist: a ctx grid goes with FlatModel "
                         "(kind 4) only")
    grids = (syms, cgrid, counts) + (() if ctxg is None else (ctxg,))
    if not _on_card(*grids):
        return train_hist_plain(syms, cgrid, model, counts, ctxg)
    _check(syms, "syms", torch.uint8, 2)
    _check(cgrid, "cgrid", torch.int32, 2)
    _check(counts, "counts", torch.int32, 2)
    T, L = syms.shape
    if (cgrid.shape[1] != L
            or tuple(counts.shape) != (model.n_ctx, model.alphabet)):
        raise ValueError("train_hist: shape mismatch")
    if ctxg is not None:
        _check(ctxg, "ctxg", torch.int32, 2)
        if ctxg.shape != syms.shape:
            raise ValueError("train_hist: ctx grid shape mismatch")
    lib = _lib()
    scratch = _chunk_scratch(lib, T, L, syms.device)
    _launch(lib.fq_train_hist, "train_hist", syms.device, _ptr(syms),
            _ptr(cgrid), cgrid.shape[0], L,
            None if ctxg is None else _ptr(ctxg), model.alphabet,
            *_spec_args(model), model.inc, _ptr(counts), T, _ptr(scratch))
    return counts


def train_rows_plain(rows: torch.Tensor, model,
                     inc: int = 1) -> torch.Tensor:
    """x inc, + init, then up to 24 halvings of every row over cap (in
    place)."""
    c = rows.long() * inc + model.init
    for _ in range(24):
        over = c.sum(dim=1, keepdim=True) > model.cap
        if not bool(over.any()):
            break
        c = torch.where(over, (c + 1) >> 1, c)
    rows.copy_(c.to(torch.int32))
    return rows


# the row pass takes at most this many partials a launch (its parameter
# space) and alphabets up to 256 (K13's symbols are bytes)
ROW_MAX_PARTS = 64


def _rows_launch(name: str, parts, out: torch.Tensor, model,
                 inc: int) -> None:
    for p in parts:
        _check(p, name, torch.int32, 2)
    if (any(p.shape != out.shape for p in parts)
            or out.shape[1] != model.alphabet):
        raise ValueError(f"{name}: shape mismatch")
    if not 1 <= len(parts) <= ROW_MAX_PARTS or model.alphabet > 256:
        raise ValueError(f"{name}: 1-{ROW_MAX_PARTS} partials of alphabets "
                         f"up to 256, not {len(parts)} of {model.alphabet}")
    ptrs = (ctypes.c_void_p * len(parts))(*[p.data_ptr() for p in parts])
    _launch(_lib().fq_train_rows, name, out.device, ptrs, len(parts),
            _ptr(out), out.shape[0], model.alphabet, inc, model.init,
            model.cap)


def train_rows(rows: torch.Tensor, model, inc: int = 1) -> torch.Tensor:
    """K13's row half on a (n_rows, A) int32 block of counts, in place:
    x inc (1 where the histogram already added model.inc a slot), +
    init, then up to 24 halvings while the row total is over cap (the
    row pass with one partial)."""
    if not _on_card(rows):
        return train_rows_plain(rows, model, inc)
    _rows_launch("train_rows", [rows], rows, model, inc)
    return rows


def train_rows_sum_plain(parts, model, inc: int = 1) -> torch.Tensor:
    """The partials summed (int32, as a psum), then train_rows_plain."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return train_rows_plain(acc, model, inc)


def train_rows_sum(parts, model, inc: int = 1) -> torch.Tensor:
    """The row pass over a device's block partials (the mesh trainer's
    reduce over 'block' and row finalize in one launch), or over the
    raw histograms of the frozen trainer's card scorer: ``parts``, 1-64
    (n_rows, A) int32 tables of the same rows on one device -> a new
    (n_rows, A) int32 table, their sum x inc + init, then up to 24
    halvings while the row total is over cap."""
    parts = list(parts)
    if not parts:
        raise ValueError("train_rows_sum: no partials")
    if not _on_card(*parts):
        return train_rows_sum_plain(parts, model, inc)
    out = torch.empty_like(parts[0])
    _rows_launch("train_rows_sum", parts, out, model, inc)
    return out


# --- K20 hist_nll: the trainer's cost model; narrow_rows --------------------

def _table_u64(t: torch.Tensor) -> torch.Tensor:
    """A count table's values as int64: u8, u16 (in int16) or int32."""
    v = t.long()
    return v & 0xFFFF if t.dtype == torch.int16 else v


def mant_bucket_plain(c: torch.Tensor, mbits: int) -> torch.Tensor:
    """frozen._mant_bucket on int64 counts: each rounded down to mbits
    significant bits, at least 1."""
    bl = torch.zeros_like(c)
    x = c.clamp(min=0)
    for shift in (32, 16, 8, 4, 2, 1):
        m = x >= (1 << shift)
        bl = torch.where(m, bl + shift, bl)
        x = torch.where(m, x >> shift, x)
    bl = torch.where(c > 0, bl + 1, 0)
    sh = (bl - mbits).clamp(min=0)
    return torch.clamp((c >> sh) << sh, min=1)


def hist_nll_plain(counts: torch.Tensor, hist: torch.Tensor,
                   log2: torch.Tensor, mbits: int = 0,
                   cap_terms: Optional[int] = None):
    """(terms, stat) as hist_nll gives them: terms[:stat[0]] the float64
    h x (log2[tot] - log2[c]) of the cells with h > 0 in row-major order
    (at most cap_terms of them written), stat[1] the largest row total."""
    c = _table_u64(counts)
    if mbits > 0:
        c = mant_bucket_plain(c, mbits)
    tot = c.sum(dim=1)
    n_tab = log2.shape[0]
    flat = hist.reshape(-1)
    nz = torch.nonzero(flat > 0).reshape(-1)
    A = hist.shape[1] if hist.dim() == 2 else 1
    lt = log2[tot[nz // A].clamp(0, n_tab - 1)]
    lc = log2[c.reshape(-1)[nz].clamp(0, n_tab - 1)]
    vals = flat[nz].double() * (lt - lc)
    cap = hist.numel() if cap_terms is None else cap_terms
    terms = torch.zeros(cap, dtype=torch.float64, device=hist.device)
    k = min(cap, vals.numel())
    terms[:k] = vals[:k]
    top = int(tot.max()) if tot.numel() else 0
    stat = torch.tensor([vals.numel(), top], dtype=torch.int64,
                        device=hist.device)
    return terms, stat


def hist_nll(counts: torch.Tensor, hist: torch.Tensor, log2: torch.Tensor,
             mbits: int = 0, cap_terms: Optional[int] = None):
    """K20: (n_rows, A) counts (uint8, int16 holding u16, or int32), the
    (n_rows, A) int32 evaluation histogram and a float64 table log2[v] =
    np.log2(v) -> (terms (cap_terms,) float64, stat (2,) int64): the
    terms h x (log2[tot] - log2[c]) of the cells with h > 0 in row-major
    order, tot the row's total of the (mbits > 0: mantissa-bucketed)
    counts; stat[0] the terms' count (the first cap_terms of them are
    written), stat[1] the largest row total (the terms read log2 past
    its end where it is not below len(log2)).  np.sum of the terms is
    frozen._hist_nll_bits bit for bit."""
    if not _on_card(counts, hist, log2):
        return hist_nll_plain(counts, hist, log2, mbits, cap_terms)
    width = _count_width(counts)
    if counts.dim() != 2 or not counts.is_contiguous():
        raise ValueError("hist_nll: counts want a contiguous 2-d table")
    _check(hist, "hist", torch.int32, 2)
    _check(log2, "log2", torch.float64, 1)
    if counts.shape != hist.shape or log2.shape[0] < 1:
        raise ValueError("hist_nll: shape mismatch")
    n_rows, A = hist.shape
    if n_rows * A >= (1 << 31):
        raise ValueError("hist_nll: tables below 2^31 cells")
    cap = hist.numel() if cap_terms is None else int(cap_terms)
    dev = hist.device
    lib = _lib()
    scratch = torch.empty((lib.fq_hist_nll_scratch_bytes(n_rows, A),),
                          dtype=torch.uint8, device=dev)
    terms = torch.empty((max(cap, 1),), dtype=torch.float64, device=dev)
    stat = torch.empty((2,), dtype=torch.int64, device=dev)
    _launch(lib.fq_hist_nll, "hist_nll", dev, _ptr(counts), width,
            _ptr(hist), n_rows, A, mbits, _ptr(log2), log2.shape[0],
            _ptr(terms), cap, _ptr(stat), _ptr(scratch), count=2)
    return terms[:cap], stat


_NARROW = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def narrow_rows_plain(counts: torch.Tensor, width: int,
                      step: int = 1) -> torch.Tensor:
    """Rows 0, step, 2 step, ... of an int32 table, each count's low
    8 (width 1: uint8) or 16 (width 2: int16 holding u16) bits, or
    itself (width 4)."""
    c = counts[::step]
    if width == 1:
        return (c & 0xFF).to(torch.uint8)
    if width == 2:
        return (((c & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)
    return c.clone() if step > 1 else c


def narrow_rows(counts: torch.Tensor, width: int,
                step: int = 1) -> torch.Tensor:
    """A (n_rows, A) int32 table in the type it ships in (frozen.
    _narrow_np: width 1 u8, 2 u16 in int16, 4 int32 as it is), every
    step-th row (the every-8th-row pricing of the big tables)."""
    if width not in _NARROW or step < 1:
        raise ValueError(f"narrow_rows: width 1, 2 or 4 and step >= 1, not "
                         f"{width}, {step}")
    if not _on_card(counts):
        return narrow_rows_plain(counts, width, step)
    _check(counts, "counts", torch.int32, 2)
    if width == 4 and step == 1:
        return counts
    n_rows, A = counts.shape
    out = torch.empty(((n_rows + step - 1) // step, A), dtype=_NARROW[width],
                      device=counts.device)
    _launch(_lib().fq_narrow_rows, "narrow_rows", counts.device,
            _ptr(counts), n_rows, A, step, width, _ptr(out))
    return out


# --- K18 ctx_shard_decode: frozen decode with the table sharded by rows ---

def _shard_partial(Fs, d0: int, n: int, ctx, low, vld, A: int):
    """The (sym, start, freq) partials of the shards d0, d0 + 1, ... whose
    flat u16 rows are ``Fs`` (n rows each): the owner's search result
    where a shard owns the lane's context, 0 elsewhere, summed."""
    steps = max(1, (A - 1).bit_length())
    sym = torch.zeros_like(low)
    start = torch.zeros_like(low)
    f = torch.zeros_like(low)
    for i, F in enumerate(Fs):
        d = d0 + i
        own = (ctx >= d * n) & (ctx < (d + 1) * n) & vld
        base = torch.where(own, ctx - d * n, 0) * (A + 1)
        lo = torch.zeros_like(low)
        hi = torch.full_like(low, A - 1)
        for _ in range(steps):
            mid = (lo + hi + 1) >> 1
            le = F[base + mid] <= low
            lo = torch.where(le, mid, lo)
            hi = torch.where(le, hi, mid - 1)
        sym += torch.where(own, lo, 0)
        start += torch.where(own, F[base + lo], 0)
        f += torch.where(own, F[base + lo + 1] - F[base + lo], 0)
    return sym, start, f


def _shard_rans(x, sym, start, f, vld, w16, off: int):
    """The rANS step of one wave on the summed partials: (new states, the
    word offset after the wave)."""
    W = w16.shape[0]
    low = x & (RANS_M - 1)
    xn = (f * (x >> PROB_BITS) + low - start) & 0xFFFFFFFF
    need = (xn < RANS_L) & vld
    rank = torch.cumsum(need.long(), dim=0) - need.long()
    wv = w16[torch.clamp(off + rank, max=W - 1)]
    xn = torch.where(need, ((xn << 16) | wv) & 0xFFFFFFFF, xn)
    return torch.where(vld, xn, x), off + int(need.sum())


def ctx_shard_decode_plain(states0: torch.Tensor, words: torch.Tensor,
                           cgrid: torch.Tensor, T: int, cums, model):
    """The wave loop of mesh._build_frozen_sharded over D shards on one
    device: shard d holds rows [d*n, (d+1)*n) of the u16 cum table
    (``cums[d]``, (n, A+1) int16); per wave each shard searches the lanes
    whose context it owns, the (sym, start, freq) partials are summed over
    the shards, and the rANS step and the model update run once.  Returns
    ((T, L) uint8 symbols, 0 at padding; (L,) int32 final states)."""
    L = states0.shape[0]
    A = model.alphabet
    dev = states0.device
    n = cums[0].shape[0]
    valid, aux = device_aux_plain(T, cgrid)
    Fs = [_u16(c).reshape(-1) for c in cums]
    w16 = _u16(words)
    st = model.lane_init(L, dev)
    x = _u32(states0)
    off = 0
    out = torch.zeros((T, L), dtype=torch.uint8, device=dev)
    for t in range(T):
        vld = valid[t]
        aux_t = {"start": aux["start"][t], "pos": aux["pos"][t]}
        sym, start, f = _shard_partial(Fs, 0, n, model.context(st, aux_t),
                                       x & (RANS_M - 1), vld, A)
        x, off = _shard_rans(x, sym, start, f, vld, w16, off)
        out[t] = torch.where(vld, sym, 0).to(torch.uint8)
        new = model.update(st, sym, aux_t)
        st = {k: torch.where(vld, new[k], st[k]) for k in st}
    return out, _to_i32(x)


class ShardDecode:
    """K18 over the shards of one stream that share one device: global
    shards shard0 .. shard0 + len(cums) - 1, ``cums`` their (n_local, A+1)
    int16 row blocks there; the stream's (L,) int32 states, (W,) int16
    padded words and (J, L) int32 read lengths on the same device.  With
    ``writer`` this device stores the (T, L) uint8 symbols (``out``) and
    the (L,) int32 final states (``x``).

    ``run`` decodes the stream when every shard of the row is here;
    ``step`` is one wave of the several-card route, each card summing
    its shards into one (1, 3, L) partial."""

    def __init__(self, states0: torch.Tensor, words: torch.Tensor,
                 cgrid: torch.Tensor, T: int, cums, model, shard0: int = 0,
                 writer: bool = True):
        if not _on_card(states0, words, cgrid, *cums):
            raise ValueError("ShardDecode runs on a CUDA card; the CPU "
                             "takes ctx_shard_decode_plain")
        _check(states0, "states0", torch.int32, 1)
        _check(words, "words", torch.int16, 1)
        _check(cgrid, "cgrid", torch.int32, 2)
        L, A = states0.shape[0], model.alphabet
        n = cums[0].shape[0]
        for c in cums:
            _check(c, "cum", torch.int16, 2)
            if tuple(c.shape) != (n, A + 1):
                raise ValueError("ShardDecode: cum shape mismatch")
        if cgrid.shape[1] != L or words.numel() < 1 or model.spec()[0] > 1:
            raise ValueError("ShardDecode: shape mismatch, or a model kind "
                             "other than seq or qual")
        dev = states0.device
        self._args = (states0, words, cgrid, cums)
        self.T, self.L, self.n = T, L, len(cums)
        self._model, self._n_local, self._shard0 = model, n, shard0
        self._writer = writer
        self.xout = torch.empty((1, 3, L), dtype=torch.int32, device=dev)
        self.out = torch.empty((T, L) if writer else (1,),
                               dtype=torch.uint8, device=dev)
        self.x = states0.clone() if writer else torch.zeros(
            (1,), dtype=torch.int32, device=dev)
        self.dev = dev
        self._ptrs = torch.tensor([c.data_ptr() for c in cums],
                                  dtype=torch.int64, device=dev)

    def _shard_args(self):
        states0, words, cgrid, _ = self._args
        m = self._model
        return [_ptr(states0), _ptr(words), words.numel(), _ptr(cgrid),
                cgrid.shape[0], self.T, self.L, _ptr(self._ptrs),
                self._n_local, m.alphabet, *_spec_args(m)]

    def run(self) -> None:
        """Every wave of a stream whose shards all lie on this device: one
        launch on K4's cluster, each lane's row read from the shard that
        owns it."""
        if not self._writer:
            raise ValueError("ShardDecode.run: the one-device route writes")
        if self.T == 0 or self.L == 0:
            return
        lib = _lib()
        lanes = torch.empty((self.L * lib.fq_decode_lane_bytes(),),
                            dtype=torch.uint8, device=self.dev)
        _launch(lib.fq_ctx_shard_run, "ctx_shard_decode", self.dev,
                *self._shard_args(), self.n, _ptr(lanes), _ptr(self.out),
                _ptr(self.x))

    def step(self, t: int, xin: Optional[torch.Tensor]) -> torch.Tensor:
        """Wave step t (0 .. T) reading ``xin`` ((P, 3, L) int32 partials
        of wave t - 1, summed over the cards; None at t = 0); returns this
        device's (1, 3, L) partial of wave t (``xout``, for t < T; step T
        writes the final states)."""
        if t > 0:
            _check(xin, "xin", torch.int32, 3)
            if xin.device != self.dev or tuple(xin.shape[1:]) != (3, self.L):
                raise ValueError("ShardDecode.step: xin shape or device")
        if not 0 <= t <= self.T:
            raise ValueError(f"ShardDecode.step: wave {t} outside 0..{self.T}")
        lib = _lib()
        if t == 0:
            self._st = torch.empty((lib.fq_ctx_shard_state_words(), self.L),
                                   dtype=torch.int32, device=self.dev)
            self._off = torch.zeros((2,), dtype=torch.int64, device=self.dev)
            w = self._writer
            # the arguments that stay from step to step, built once
            self._step_args = (
                self._shard_args() + [self._shard0, self.n],
                [_ptr(self.xout), _ptr(self._st), _ptr(self._off),
                 _ptr(self.out) if w else None, _ptr(self.x) if w else None])
        head, tail = self._step_args
        _launch(lib.fq_ctx_shard_step, "ctx_shard_decode", self.dev, *head,
                None if xin is None else _ptr(xin),
                0 if xin is None else xin.shape[0], *tail, t)
        return self.xout


def ctx_shard_decode(states0: torch.Tensor, words: torch.Tensor,
                     cgrid: torch.Tensor, T: int, cums, model):
    """K18: one stream decoded against a u16 cum table split by rows into
    ``cums`` (D (n, A+1) int16 blocks, shard order) that all lie with the
    stream's (L,) int32 states, (W,) int16 padded words and (J, L) int32
    read lengths on one device -> ((T, L) uint8 symbols, 0 at padding;
    (L,) int32 final states).  Shards spread over several cards:
    parallel/mesh.py steps a ShardDecode a card."""
    if not _on_card(states0, words, cgrid, *cums):
        return ctx_shard_decode_plain(states0, words, cgrid, T, cums, model)
    run = ShardDecode(states0, words, cgrid, T, cums, model)
    run.run()
    return run.out, run.x


# --- the seed aligner: K8 align_batch, K9 indel_batch ------------------------
#
# Both plain versions follow fastqueeze_tpu/align/hash.py (_one_strand,
# _align_batch, _indel_batch) over (B, Lp) code grids, with one change
# that only the fallback anchor of an unmapped read can see: the probe
# count a candidate is ranked by is the native host mirror's
# (native/alignhost.cpp one_strand), which stops at the first probe word
# once that alone exceeds max_mis and ranks the candidate as that count
# + 8.  Every surviving candidate (probe count <= max_mis) has the exact
# count either way, so mapped reads agree with the JAX kernels; the
# indel tier anchors on unmapped reads' fallbacks, and there the kernels,
# the plain versions and the native mirror agree with each other.

class AlignIndex(NamedTuple):
    """The reference index on one device: keys (int32 for k <= 15, int64
    for the wide k <= 31 keys), CSR offsets and positions (int32), the
    2-bit packed reference (int32 holding u32 words, no host padding),
    the first-level bucket table l1 (int32), and its scalars."""
    keys: torch.Tensor
    offsets: torch.Tensor
    positions: torch.Tensor
    packed: torch.Tensor
    l1: torch.Tensor
    l1_shift: int
    search_steps: int
    ref_len: int


ALIGN_BIG = 1 << 28
_M32 = 0xFFFFFFFF


def _popcount32(y: torch.Tensor) -> torch.Tensor:
    y = y - ((y >> 1) & 0x55555555)
    y = (y & 0x33333333) + ((y >> 2) & 0x33333333)
    y = (y + (y >> 4)) & 0x0F0F0F0F
    return ((y * 0x01010101) & _M32) >> 24


def _mis2bit(x: torch.Tensor) -> torch.Tensor:
    """Differing 2-bit slots of u32 XOR words (int64 holding u32)."""
    return _popcount32((x | (x >> 1)) & 0x55555555)


def _pack_words(codes: torch.Tensor, valid: torch.Tensor):
    """(B, Lp) codes + validity -> (B, W) int64 MSB-first u32 words and
    their 2-bit-slot masks."""
    B, Lp = codes.shape
    shifts = 2 * (15 - torch.arange(16, device=codes.device))
    c = torch.where(valid, codes.long(), 0).reshape(B, Lp // 16, 16)
    m = torch.where(valid, 3, 0).reshape(B, Lp // 16, 16)
    return (c << shifts).sum(2), (m << shifts).sum(2)


def _frame(arr: torch.Tensor, j: int, sh: torch.Tensor) -> torch.Tensor:
    """Word j of the read funnel-shifted into a candidate's ref frame
    (hash._read_in_ref_frame); arr (B, W), sh (B, C) = 2 * (cand & 15)."""
    W = arr.shape[1]
    b = arr[:, j, None] if j < W else torch.zeros_like(sh)
    out = b >> sh
    if j >= 1:
        a = arr[:, j - 1, None] if j <= W else torch.zeros_like(sh)
        shl = 32 - torch.clamp(sh, min=1)
        out = out | torch.where(sh > 0, (a << shl) & _M32, 0)
    return out


def _mis_aligned(packed: torch.Tensor, cand: torch.Tensor, rw, mw, js):
    """Mismatch counts of the read against the ref window at each u32
    candidate, over frame words js (hash._mis_aligned)."""
    nw = packed.numel()
    w0 = cand >> 4
    sh = 2 * (cand & 15)
    mis = torch.zeros_like(cand)
    for j in js:
        refw = packed[torch.clamp(w0 + j, 0, nw - 1)]
        mis += _mis2bit((_frame(rw, j, sh) ^ refw) & _frame(mw, j, sh))
    return mis


def _ref_base_at(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    w = packed[torch.clamp(idx >> 4, 0, packed.numel() - 1)]
    return (w >> (2 * (15 - (idx & 15)))) & 3


def _rc_grid(codes: torch.Tensor, dege: torch.Tensor, lens: torch.Tensor):
    """Per read: base i <- 3 - codes[len-1-i], zero past the length."""
    Lp = codes.shape[1]
    pos_i = torch.arange(Lp, device=codes.device)[None, :]
    valid = pos_i < lens[:, None]
    ridx = torch.clamp(lens[:, None] - 1 - pos_i, 0, Lp - 1)
    rc = torch.where(valid, 3 - codes.long().gather(1, ridx), 0)
    rdege = valid & dege.gather(1, ridx)
    return rc, rdege


def _one_strand_plain(cfg, ix: AlignIndex, codes: torch.Tensor,
                      dege: torch.Tensor, lens: torch.Tensor):
    """(B, Lp) effective-strand codes -> (best mismatch count, best
    window start as int64 holding the int32 value) over the candidates
    of the n_seeds least-frequent sampled seeds (hash._one_strand)."""
    B, Lp = codes.shape
    dev = codes.device
    k, C = cfg.k, cfg.n_cand
    BIG = ALIGN_BIG
    c64 = codes.long()
    ps = torch.arange(0, Lp - k + 1, cfg.stride, device=dev)
    kv = torch.zeros((B, ps.numel()), dtype=torch.int64, device=dev)
    for j in range(k):
        kv = (kv << 2) | c64[:, ps + j]
    cs = torch.nn.functional.pad(torch.cumsum(dege.long(), 1), (1, 0))
    ok_s = ((ps[None, :] <= lens[:, None] - k)
            & (cs[:, ps + k] - cs[:, ps] == 0))
    keys, l1 = ix.keys.long(), ix.l1.long()
    offs, posv = ix.offsets.long(), ix.positions.long()
    nk = keys.numel()
    q = kv >> ix.l1_shift
    lo, hi = l1[q], l1[q + 1]
    hi0 = hi
    for _ in range(ix.search_steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        less = keys[torch.clamp(mid, max=nk - 1)] < kv
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    ii = torch.clamp(lo, max=nk - 1)
    found = (keys[ii] == kv) & (lo < hi0) & ok_s
    occ = torch.where(found, offs[ii + 1] - offs[ii], BIG)

    cj = torch.arange(C, device=dev)[None, :]
    cands, oks = [], []
    for _ in range(cfg.n_seeds):
        jb = torch.argmin(occ, dim=1)
        occ_best = occ.gather(1, jb[:, None])[:, 0]
        pb = ps[jb]
        if cfg.excl_bp > 0:
            occ = torch.where((ps[None, :] - pb[:, None]).abs()
                              <= cfg.excl_bp, BIG, occ)
        else:
            occ = occ.scatter(1, jb[:, None], BIG)
        base = offs[ii.gather(1, jb[:, None])[:, 0]]
        in_range = cj < torch.clamp(occ_best, max=C)[:, None]
        ptr = torch.clamp(base[:, None] + cj, 0, posv.numel() - 1)
        cand = posv[ptr] - pb[:, None]
        cands.append(cand)
        oks.append(in_range & (cand >= 0)
                   & (cand + lens[:, None] <= ix.ref_len))
    cand = torch.cat(cands, 1) & _M32          # u32 frame arithmetic
    cand_ok = torch.cat(oks, 1)

    pos_i = torch.arange(Lp, device=dev)[None, :]
    rw, mw = _pack_words(codes, pos_i < lens[:, None])
    packed = ix.packed.long() & _M32
    W = Lp // 16
    K = cfg.probe_k
    if K > 0 and cand.shape[1] > 2 * K and W > 3:
        p1 = _mis_aligned(packed, cand, rw, mw, (1,))
        p2 = _mis_aligned(packed, cand, rw, mw, (W // 2,))
        pm = torch.where(p1 > cfg.max_mis, p1 + 8, p1 + p2)
        pmis = torch.where(cand_ok, pm, BIG)
        # lax.top_k's order: stable, smaller count first, ties by index
        sel = torch.sort(pmis, dim=1, stable=True).indices[:, :K]
        cand = cand.gather(1, sel)
        cand_ok = cand_ok.gather(1, sel) & (pmis.gather(1, sel)
                                            <= cfg.max_mis)
    mis = torch.where(cand_ok,
                      _mis_aligned(packed, cand, rw, mw, range(W + 1)), BIG)
    cb = torch.argmin(mis, dim=1)[:, None]
    pos = cand.gather(1, cb)[:, 0]
    return mis.gather(1, cb)[:, 0], pos - ((pos >> 31) << 32)


def align_batch_plain(codes: torch.Tensor, dege: torch.Tensor,
                      lengths: torch.Tensor, ix: AlignIndex, cfg):
    """hash._align_batch: (mapped, pos int32, is_rev, mis_mask)."""
    B, Lp = codes.shape
    lens = lengths.long()
    pos_i = torch.arange(Lp, device=codes.device)[None, :]
    valid = pos_i < lens[:, None]
    has_dege = (dege & valid).any(1)
    if cfg.strand != "rc":
        mis_f, pos_f = _one_strand_plain(cfg, ix, codes, dege, lens)
    if cfg.strand != "fwd":
        rc, rdege = _rc_grid(codes, dege, lens)
        mis_r, pos_r = _one_strand_plain(cfg, ix, rc, rdege, lens)
    if cfg.strand == "fwd":
        use_rev = torch.zeros(B, dtype=torch.bool, device=codes.device)
        mis, pos, eff = mis_f, pos_f, codes.long()
    elif cfg.strand == "rc":
        use_rev = mis_r <= cfg.max_mis
        mis, pos, eff = mis_r, pos_r, rc
    else:
        use_rev = (mis_r < mis_f) if cfg.both_strands else (mis_f
                                                            > cfg.max_mis)
        mis = torch.where(use_rev, mis_r, mis_f)
        pos = torch.where(use_rev, pos_r, pos_f)
        eff = torch.where(use_rev[:, None], rc, codes.long())
    mapped = (mis <= cfg.max_mis) & ~has_dege & (lens >= cfg.k)
    refc = _ref_base_at(ix.packed.long() & _M32,
                        torch.clamp(pos, min=0)[:, None] + pos_i)
    mis_mask = (eff != refc) & valid & mapped[:, None]
    return mapped, pos.to(torch.int32), use_rev & mapped, mis_mask


def _exc(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumsum along the read: column s = count over i < s."""
    return torch.nn.functional.pad(torch.cumsum(x.long(), 1), (1, 0))


def _argmin_pick(tot, ok, best):
    """First-occurrence argmin of tot over the ok columns; returns
    (value, column, strictly better than ``best``)."""
    tot = torch.where(ok, tot, ALIGN_BIG)
    sb = torch.argmin(tot, dim=1)
    tb = tot.gather(1, sb[:, None])[:, 0]
    return tb, sb, tb < best


def _indel_strand_plain(cfg, G: int, ops: int, ix: AlignIndex, c, d, lens):
    """hash._indel_batch's strand_eval: (tot, sA, gA, sB, gB, pos, mask)."""
    B, Lp = c.shape
    dev = c.device
    BIG = ALIGN_BIG
    _, posi = _one_strand_plain(cfg, ix, c, d, lens)
    pos_i = torch.arange(Lp, device=dev)[None, :]
    s_grid = torch.arange(Lp + 1, device=dev)[None, :]
    valid = pos_i < lens[:, None]
    c = c.long()
    ok_b = (posi >= 2 * G) & (posi + lens + 2 * G <= ix.ref_len)
    packed = ix.packed.long() & _M32
    cmp = [(c != _ref_base_at(packed, torch.clamp(
        posi[:, None] + g + pos_i, 0, ix.ref_len - 1))) & valid
        for g in range(-G, G + 1)]
    E = [_exc(x) for x in cmp]
    F = _exc((c != 0) & valid)
    E0 = E[G]
    T = [e[:, -1:] for e in E]
    len1 = lens[:, None]
    z = torch.zeros(B, dtype=torch.int64, device=dev)
    tot_b = torch.full((B,), BIG, dtype=torch.int64, device=dev)
    s_b, g_b, pg_b, sg_b, po_b = z, z, z, z, posi

    def pad(t, h):
        return torch.nn.functional.pad(t, (0, h), value=BIG)

    def consider(tot, ok, g_out, d_pos, pg, sg):
        nonlocal tot_b, s_b, g_b, po_b, pg_b, sg_b
        tb, sb, better = _argmin_pick(tot, ok, tot_b)
        tot_b = torch.where(better, tb, tot_b)
        s_b = torch.where(better, sb, s_b)
        g_b = torch.where(better, g_out, g_b)
        po_b = torch.where(better, posi + d_pos, po_b)
        pg_b = torch.where(better, pg + G, pg_b)
        sg_b = torch.where(better, sg + G, sg_b)

    for g in range(-G, G + 1):
        if g == 0:
            continue
        Eg, Tg, h = E[g + G], T[g + G], abs(g)
        lit = F[:, h:] - F[:, :Lp + 1 - h]
        if g > 0:
            consider(E0 + (Tg - Eg), s_grid <= len1, g, 0, 0, g)
            consider(pad(Eg[:, :Lp + 1 - h] + lit + (T[G] - E0[:, h:]), h),
                     s_grid <= len1 - h, -g, g, g, 0)
        else:
            consider(pad(E0[:, :Lp + 1 - h] + lit + (Tg - Eg[:, h:]), h),
                     s_grid <= len1 - h, g, 0, 0, g)
            consider(Eg + (T[G] - E0), s_grid <= len1, -g, g, g, 0)
    tot_b = torch.where(ok_b, tot_b, BIG)

    sA_b, gA_b, sB_b, gB_b = s_b, g_b, z, z
    jb_b, poo_b = pg_b, po_b
    E_st = torch.stack(E, 1)                          # (B, 2G+1, Lp+1)

    def row_of(j):
        return E_st.gather(1, torch.clamp(j, 0, 2 * G)[:, None, None]
                           .expand(B, 1, Lp + 1))[:, 0]

    def at(X, i):
        return X.gather(1, i[:, None])[:, 0]

    if ops >= 2:
        Epg, Esg = row_of(pg_b), row_of(sg_b)
        s1h = s_b + torch.clamp(-g_b, min=0)
        op1_lit = at(F, s1h) - at(F, s_b)
        elig = ((tot_b > cfg.max_mis) & (tot_b < BIG))[:, None]
        base_c = (at(Epg, s_b) + op1_lit - at(Esg, s1h))[:, None]
        t2_b, s2_b, g2_b = torch.full_like(tot_b, BIG), z, z
        for g2 in range(-G, G + 1):
            if g2 == 0:
                continue
            j2 = sg_b + g2
            okj = ((j2 >= 0) & (j2 <= 2 * G))[:, None]
            E2 = row_of(j2)
            e2len = at(E2, lens)[:, None]
            h2 = -g2 if g2 < 0 else 0
            if h2:
                tot = pad(Esg[:, :Lp + 1 - h2]
                          + (F[:, h2:] - F[:, :Lp + 1 - h2])
                          + (e2len - E2[:, h2:]), h2)
            else:
                tot = Esg + (e2len - E2)
            ok = ((s_grid >= s1h[:, None]) & (s_grid <= len1 - h2)
                  & okj & elig)
            tb, sb, better = _argmin_pick(base_c + tot, ok, t2_b)
            t2_b = torch.where(better, tb, t2_b)
            s2_b = torch.where(better, sb, s2_b)
            g2_b = torch.where(better, g2, g2_b)
        tail_c = (op1_lit + at(Esg, lens) - at(Esg, s1h)
                  + at(Epg, s_b))[:, None]
        th_b, s0_b, gh_b = torch.full_like(tot_b, BIG), z, z
        for gh in range(-G, G + 1):
            if gh == 0:
                continue
            j0 = pg_b + gh
            okj = ((j0 >= 0) & (j0 <= 2 * G))[:, None]
            Ej0 = row_of(j0)
            hh = gh if gh > 0 else 0
            if hh:
                tot = pad(Ej0[:, :Lp + 1 - hh]
                          + (F[:, hh:] - F[:, :Lp + 1 - hh])
                          - Epg[:, hh:], hh)
            else:
                tot = Ej0 - Epg
            ok = (s_grid <= s_b[:, None] - hh) & okj & elig
            tb, sb, better = _argmin_pick(tail_c + tot, ok, th_b)
            th_b = torch.where(better, tb, th_b)
            s0_b = torch.where(better, sb, s0_b)
            gh_b = torch.where(better, gh, gh_b)
        use_head = th_b < t2_b
        better2 = torch.minimum(t2_b, th_b) < tot_b
        tot_b = torch.where(better2, torch.minimum(t2_b, th_b), tot_b)
        uh, ut = better2 & use_head, better2 & ~use_head
        sA_b = torch.where(uh, s0_b, s_b)
        gA_b = torch.where(uh, -gh_b, g_b)
        sB_b = torch.where(uh, s_b, torch.where(ut, s2_b, 0))
        gB_b = torch.where(uh, g_b, torch.where(ut, g2_b, 0))
        jb_b = torch.where(uh, pg_b + gh_b, pg_b)
        poo_b = torch.where(uh, po_b + gh_b, po_b)

    cmp_st = torch.stack(cmp, 1)                      # (B, 2G+1, Lp)

    def seg_row(j):
        return cmp_st.gather(1, torch.clamp(j, 0, 2 * G)[:, None, None]
                             .expand(B, 1, Lp))[:, 0]

    r0, r1 = seg_row(jb_b), seg_row(jb_b + gA_b)
    r2 = seg_row(jb_b + gA_b + gB_b)
    lit = (c != 0) & valid
    hA = torch.clamp(-gA_b, min=0)[:, None]
    hB = torch.clamp(-gB_b, min=0)[:, None]
    sAm, sBm = sA_b[:, None], sB_b[:, None]
    mask = torch.where(
        pos_i < sAm, r0,
        torch.where(pos_i < sAm + hA, torch.where(hA > 0, lit, r1),
                    torch.where(pos_i < sBm, r1,
                                torch.where(pos_i < sBm + hB,
                                            torch.where(hB > 0, lit, r2),
                                            r2))))
    return tot_b, sA_b, gA_b, sB_b, gB_b, poo_b, mask & valid


def indel_batch_plain(codes: torch.Tensor, dege: torch.Tensor,
                      lengths: torch.Tensor, ix: AlignIndex, cfg, G: int,
                      ops: int):
    """hash._indel_batch: (found, pos, s1, g1, s2, g2 int32, is_rev,
    mis_mask in spliced-window coordinates)."""
    lens = lengths.long()
    Lp = codes.shape[1]
    valid = torch.arange(Lp, device=codes.device)[None, :] < lens[:, None]
    has_dege = (dege & valid).any(1)
    f = _indel_strand_plain(cfg, G, ops, ix, codes, dege, lens)
    rc, rdege = _rc_grid(codes, dege, lens)
    r = _indel_strand_plain(cfg, G, ops, ix, rc, rdege, lens)
    use_rev = r[0] < f[0]
    tot = torch.where(use_rev, r[0], f[0])
    found = (tot <= cfg.max_mis) & ~has_dege & (lens >= cfg.k)
    outs = [torch.where(use_rev, b, a).to(torch.int32)
            for a, b in zip(f[5:6] + f[1:5], r[5:6] + r[1:5])]
    return (found, *outs, use_rev & found,
            torch.where(use_rev[:, None], r[6], f[6]))


def _align_cfg_args(cfg) -> list:
    return [cfg.k, cfg.stride, cfg.n_cand, cfg.max_mis, cfg.n_seeds,
            cfg.excl_bp, cfg.probe_k, cfg.lp]


def _check_align(codes, dege, lengths, ix: AlignIndex, cfg, name: str):
    _check(codes, "codes", torch.uint8, 2)
    _check(dege, "dege", torch.bool, 2)
    _check(lengths, "lengths", torch.int32, 1)
    B, Lp = codes.shape
    if (tuple(dege.shape) != (B, Lp) or lengths.numel() != B
            or Lp != cfg.lp or Lp % 16):
        raise ValueError(f"{name}: shape mismatch")
    wide = ix.keys.dtype == torch.int64
    if wide != (cfg.k > 15) or (not wide and ix.keys.dtype != torch.int32):
        raise ValueError(f"{name}: keys must be int64 for k > 15, int32 "
                         f"otherwise")
    for t, n in ((ix.offsets, "offsets"), (ix.positions, "positions"),
                 (ix.packed, "packed"), (ix.l1, "l1")):
        _check(t, n, torch.int32, 1)
    return B, wide


def _index_ptrs(ix: AlignIndex, wide: bool) -> list:
    return [_ptr(ix.keys), int(wide), ix.keys.numel(), _ptr(ix.offsets),
            _ptr(ix.positions), ix.positions.numel(), _ptr(ix.packed),
            ix.packed.numel(), _ptr(ix.l1), ix.l1_shift, ix.search_steps,
            ix.ref_len]


def align_batch(codes: torch.Tensor, dege: torch.Tensor,
                lengths: torch.Tensor, ix: AlignIndex, cfg):
    """K8: (B, Lp) uint8 codes (degenerate bases as 0, zero past each
    length), (B, Lp) bool degenerate flags, (B,) int32 lengths <= Lp and
    the index -> ((B,) bool mapped, (B,) int32 window start, (B,) bool
    reverse strand, (B, Lp) bool mismatch mask).  Only ``mapped`` and the
    mapped reads' other outputs carry meaning."""
    tensors = (codes, dege, lengths) + tuple(ix[:5])
    if not _on_card(*tensors):
        return align_batch_plain(codes, dege, lengths, ix, cfg)
    B, wide = _check_align(codes, dege, lengths, ix, cfg, "align_batch")
    dev = codes.device
    mapped = torch.zeros((B,), dtype=torch.bool, device=dev)
    pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    rev = torch.zeros((B,), dtype=torch.bool, device=dev)
    mm = torch.zeros((B, cfg.lp), dtype=torch.bool, device=dev)
    if B == 0:
        return mapped, pos, rev, mm
    lib = _lib()
    per = lib.fq_align_scratch_bytes(*_align_cfg_args(cfg))
    scratch = torch.empty((B * per,), dtype=torch.uint8, device=dev)
    mode = {"fwd": 0, "rc": 1, "both": 2}[cfg.strand]
    _launch(lib.fq_align_batch_cuda, "align_batch", dev,
            *_index_ptrs(ix, wide),
            *_align_cfg_args(cfg), _ptr(codes), _ptr(dege), _ptr(lengths),
            B, mode, int(cfg.both_strands), _ptr(scratch), per,
            _ptr(mapped), _ptr(pos), _ptr(rev), _ptr(mm))
    return mapped, pos, rev, mm


def indel_batch(codes: torch.Tensor, dege: torch.Tensor,
                lengths: torch.Tensor, ix: AlignIndex, cfg, G: int,
                ops: int):
    """K9: the indel tier over the inputs of align_batch, gap size up to
    G and up to ``ops`` (1 or 2) gap operations a read -> ((B,) bool
    found, (B,) int32 pos, split s1, gap g1, split s2, gap g2, (B,) bool
    reverse strand, (B, Lp) bool mask in spliced-window coordinates).
    Only ``found`` and the found reads' other outputs carry meaning."""
    tensors = (codes, dege, lengths) + tuple(ix[:5])
    if not _on_card(*tensors):
        return indel_batch_plain(codes, dege, lengths, ix, cfg, G, ops)
    B, wide = _check_align(codes, dege, lengths, ix, cfg, "indel_batch")
    if not (1 <= G < cfg.lp) or ops not in (1, 2):
        raise ValueError("indel_batch: need 1 <= G < Lp and ops in (1, 2)")
    dev = codes.device
    found = torch.zeros((B,), dtype=torch.bool, device=dev)
    ints = [torch.zeros((B,), dtype=torch.int32, device=dev)
            for _ in range(5)]
    rev = torch.zeros((B,), dtype=torch.bool, device=dev)
    mm = torch.zeros((B, cfg.lp), dtype=torch.bool, device=dev)
    if B == 0:
        return (found, *ints, rev, mm)
    lib = _lib()
    per = lib.fq_indel_scratch_bytes(*_align_cfg_args(cfg), G)
    scratch = torch.empty((B * per,), dtype=torch.uint8, device=dev)
    _launch(lib.fq_indel_batch_cuda, "indel_batch", dev,
            *_index_ptrs(ix, wide),
            *_align_cfg_args(cfg), _ptr(codes), _ptr(dege), _ptr(lengths),
            B, G, ops, _ptr(scratch), per, _ptr(found),
            *(_ptr(t) for t in ints), _ptr(rev), _ptr(mm))
    return (found, *ints, rev, mm)


# --- K10 window_batch: the PE mate-rescue window ----------------------------

def window_batch_plain(packed: torch.Tensor, ref_len: int,
                       codes: torch.Tensor, dege: torch.Tensor,
                       lengths: torch.Tensor, centers: torch.Tensor, C: int,
                       max_mis: int):
    """hash._window_batch: every candidate of [center - C/2, center + C/2)
    verified on both strands over all W+1 frame words, first-occurrence
    argmin per strand, RC only when strictly better -> (mapped, pos int32,
    is_rev, mis_mask)."""
    B, Lp = codes.shape
    dev = codes.device
    lens = lengths.long()
    pos_i = torch.arange(Lp, device=dev)[None, :]
    valid = pos_i < lens[:, None]
    has_dege = (dege & valid).any(1)
    cand = (centers.long()[:, None] - C // 2
            + torch.arange(C, device=dev)[None, :])
    cand_ok = (cand >= 0) & (cand + lens[:, None] <= ref_len)
    pk = packed.long() & _M32
    W = Lp // 16

    def strand(c):
        rw, mw = _pack_words(c, valid)
        mis = _mis_aligned(pk, cand & _M32, rw, mw, range(W + 1))
        mis = torch.where(cand_ok, mis, ALIGN_BIG)
        cb = torch.argmin(mis, dim=1)[:, None]
        return mis.gather(1, cb)[:, 0], cand.gather(1, cb)[:, 0]

    mis_f, pos_f = strand(codes)
    rc, _ = _rc_grid(codes, dege, lens)
    mis_r, pos_r = strand(rc)
    use_rev = mis_r < mis_f
    mis = torch.where(use_rev, mis_r, mis_f)
    pos = torch.where(use_rev, pos_r, pos_f)
    mapped = (mis <= max_mis) & ~has_dege
    eff = torch.where(use_rev[:, None], rc, codes.long())
    refc = _ref_base_at(pk, torch.clamp(pos, min=0)[:, None] + pos_i)
    mis_mask = (eff != refc) & valid & mapped[:, None]
    return mapped, pos.to(torch.int32), use_rev & mapped, mis_mask


def window_batch(packed: torch.Tensor, ref_len: int, codes: torch.Tensor,
                 dege: torch.Tensor, lengths: torch.Tensor,
                 centers: torch.Tensor, C: int, max_mis: int):
    """K10: (nw,) int32 packed reference (u32 words), (B, Lp) uint8 codes
    (zero past each length), (B, Lp) bool degenerate flags, (B,) int32
    lengths <= Lp and (B,) int32 window centers, window size C ->
    ((B,) bool mapped, (B,) int32 window start, (B,) bool reverse strand,
    (B, Lp) bool mismatch mask).  Only ``mapped`` and the mapped reads'
    other outputs carry meaning."""
    if not _on_card(packed, codes, dege, lengths, centers):
        return window_batch_plain(packed, ref_len, codes, dege, lengths,
                                  centers, C, max_mis)
    _check(packed, "packed", torch.int32, 1)
    _check(codes, "codes", torch.uint8, 2)
    _check(dege, "dege", torch.bool, 2)
    _check(lengths, "lengths", torch.int32, 1)
    _check(centers, "centers", torch.int32, 1)
    B, Lp = codes.shape
    if (tuple(dege.shape) != (B, Lp) or lengths.numel() != B
            or centers.numel() != B):
        raise ValueError("window_batch: shape mismatch")
    if Lp % 16 or Lp == 0 or C <= 0 or packed.numel() == 0:
        raise ValueError("window_batch: need Lp a positive multiple of 16, "
                         "C > 0 and a non-empty reference")
    dev = codes.device
    # K10 writes every byte of all four, degenerate reads' rows too
    mapped = torch.empty((B,), dtype=torch.bool, device=dev)
    pos = torch.empty((B,), dtype=torch.int32, device=dev)
    rev = torch.empty((B,), dtype=torch.bool, device=dev)
    mm = torch.empty((B, Lp), dtype=torch.bool, device=dev)
    if B == 0:
        return mapped, pos, rev, mm
    _launch(_lib().fq_window_batch_cuda, "window_batch", dev, _ptr(packed),
            packed.numel(), ref_len, _ptr(codes), _ptr(dege), _ptr(lengths),
            _ptr(centers), B, Lp, C, max_mis, _ptr(mapped), _ptr(pos),
            _ptr(rev), _ptr(mm))
    return mapped, pos, rev, mm


# --- K14 rescue_indel_fused: the rescue and indel tiers in one launch -------

def _fused_zeros(cap: int, Lp: int, dev):
    """K14's twelve outputs, zero: (m2, p2, r2, mm2) then (f, pi, s1, g1,
    s2, g2, ri, mmi)."""
    def z(dtype, *shape):
        return torch.zeros((cap,) + shape, dtype=dtype, device=dev)
    b, i = torch.bool, torch.int32
    return (z(b), z(i), z(b), z(b, Lp), z(b), z(i), z(i), z(i), z(i), z(i),
            z(b), z(b, Lp))


def rescue_indel_fused_plain(codes: torch.Tensor, dege: torch.Tensor,
                             lengths: torch.Tensor, idx: torch.Tensor,
                             do: torch.Tensor, ix: AlignIndex, cfg2, cfg3,
                             G: int, ops: int):
    """hash._rescue_indel_fused: gather the todo rows (length 0 where
    ``do`` is false), the rescue tier over them (cfg2; None disables it),
    then the indel tier (cfg3, G, ops; ops 0 disables it) over the slots
    the rescue did not map."""
    sel = idx.long()
    c, d = codes[sel], dege[sel]
    ln = torch.where(do, lengths[sel], 0)
    cap, Lp = c.shape
    if cfg2 is not None:
        m2, p2, r2, mm2 = align_batch_plain(c, d, ln, ix, cfg2)
        m2 = m2 & do
    else:
        m2, p2, r2, mm2 = _fused_zeros(cap, Lp, c.device)[:4]
    if ops > 0:
        bad = do & ~m2
        f, *rest = indel_batch_plain(c, d, torch.where(bad, ln, 0), ix,
                                     cfg3, G, ops)
        return (m2, p2, r2, mm2, f & bad, *rest)
    return (m2, p2, r2, mm2, *_fused_zeros(cap, Lp, c.device)[4:])


def rescue_indel_fused(codes: torch.Tensor, dege: torch.Tensor,
                       lengths: torch.Tensor, idx: torch.Tensor,
                       do: torch.Tensor, ix: AlignIndex, cfg2, cfg3, G: int,
                       ops: int):
    """K14: over one batch's (B, Lp) grids (as align_batch takes them) and
    a todo list of (cap,) int32 row indices with their (cap,) bool flags,
    the rescue tier (cfg2, both strands; None: off) and the indel tier
    (cfg3, gap size up to G, ``ops`` gap operations; 0: off) on the slots
    the rescue left unmapped -> (m2, p2, r2, mm2) as align_batch returns
    them and (f, pi, s1, g1, s2, g2, ri, mmi) as indel_batch does, m2
    masked to do and f to do & ~m2.  Only m2, f and the outputs of the
    slots they select carry meaning."""
    tensors = (codes, dege, lengths, idx, do) + tuple(ix[:5])
    if not _on_card(*tensors):
        return rescue_indel_fused_plain(codes, dege, lengths, idx, do, ix,
                                        cfg2, cfg3, G, ops)
    B, wide = _check_align(codes, dege, lengths, ix, cfg3,
                           "rescue_indel_fused")
    _check(idx, "idx", torch.int32, 1)
    _check(do, "do", torch.bool, 1)
    cap, Lp = idx.numel(), cfg3.lp
    if do.numel() != cap:
        raise ValueError("rescue_indel_fused: idx and do differ in length")
    if cfg2 is not None and (cfg2.strand != "both" or cfg2.k != cfg3.k
                             or cfg2.lp != Lp):
        raise ValueError("rescue_indel_fused: cfg2 must search both strands "
                         "with cfg3's k and lp")
    if ops not in (0, 1, 2) or (ops and not 1 <= G < Lp):
        raise ValueError("rescue_indel_fused: need ops in (0, 1, 2) and "
                         "1 <= G < Lp when ops > 0")
    dev = codes.device
    outs = _fused_zeros(cap, Lp, dev)
    if cap == 0 or B == 0 or (cfg2 is None and ops == 0):
        return outs
    lib = _lib()
    per = max(lib.fq_align_scratch_bytes(*_align_cfg_args(cfg2))
              if cfg2 is not None else 0,
              lib.fq_indel_scratch_bytes(*_align_cfg_args(cfg3), G)
              if ops else 0)
    scratch = torch.empty((cap * per,), dtype=torch.uint8, device=dev)
    _launch(lib.fq_rescue_indel_fused_cuda, "rescue_indel_fused", dev,
            *_index_ptrs(ix, wide),
            *_align_cfg_args(cfg2 if cfg2 is not None else cfg3),
            int(cfg2 is not None), *_align_cfg_args(cfg3), G, ops,
            _ptr(codes), _ptr(dege), _ptr(lengths), B, _ptr(idx), _ptr(do),
            cap, int(cfg3.both_strands), _ptr(scratch), per,
            *(_ptr(t) for t in outs))
    return outs


# --- K19 sharded_align: the key-range-sharded index, u32 coordinates --------
#
# One shard of parallel/mesh.shard_ref_index on its device: u32 keys (hi,
# lo30 for k > 15; hi alone otherwise) padded with 0xFFFFFFFF to kp, the
# shard's CSR offsets (kp + 1) and u32 positions, all as int32 tensors
# holding the same bits, and the whole packed reference.  The shards that
# share a device come stacked, (D, kp) keys, (D, kp + 1) offsets, (D, pp)
# positions: each phase then runs them all in one launch and returns its
# outputs stacked (D, B, ...).  The phases' collectives (pmin / pmax over
# the shards) are parallel/mesh.py's.

class ShardIndex(NamedTuple):
    keys_hi: torch.Tensor
    keys_lo: torch.Tensor
    offsets: torch.Tensor
    positions: torch.Tensor
    packed: torch.Tensor
    ref_len: int
    k: int
    steps: int          # ceil(log2(kp + 1)) binary-search steps


def shard_count(sx: ShardIndex) -> Optional[int]:
    """The number of stacked shards in ``sx``, None for one shard."""
    return sx.keys_hi.shape[0] if sx.keys_hi.dim() == 2 else None


def _shard_at(sx: ShardIndex, d: int) -> ShardIndex:
    return sx._replace(keys_hi=sx.keys_hi[d], keys_lo=sx.keys_lo[d],
                       offsets=sx.offsets[d], positions=sx.positions[d])


def _stacked(sx: ShardIndex, fn, *per_shard):
    """fn(one shard, its slices of per_shard) over the stacked shards of
    ``sx``, each output stacked (D, ...); fn(sx, *per_shard) for one."""
    D = shard_count(sx)
    if D is None:
        return fn(sx, *per_shard)
    outs = [fn(_shard_at(sx, d), *(a[d] for a in per_shard))
            for d in range(D)]
    return tuple(torch.stack(x) for x in zip(*outs))


def n_seed_samples(Lp: int, k: int, stride: int) -> int:
    return len(range(0, Lp - k + 1, stride))


def _eff_grid(codes: torch.Tensor, dege: torch.Tensor,
              lengths: torch.Tensor, rc: bool):
    """The read's effective strand: (int64 codes, bool degenerate flags)."""
    if rc:
        return _rc_grid(codes, dege, lengths.long())
    return codes.long(), dege


def sharded_lookup_plain(codes: torch.Tensor, dege: torch.Tensor,
                         lengths: torch.Tensor, sx: ShardIndex, stride: int,
                         rc: bool):
    """_one_strand's shard_axis lookup on one shard: ((B, S) int32 occ,
    bool found, int32 key index where found, 0 elsewhere); (D, B, S) each
    for D stacked shards."""
    if shard_count(sx) is not None:
        return _stacked(sx, lambda x: sharded_lookup_plain(
            codes, dege, lengths, x, stride, rc))
    B, Lp = codes.shape
    k = sx.k
    lens = lengths.long()
    c, d = _eff_grid(codes, dege, lengths, rc)
    ps = torch.arange(0, Lp - k + 1, stride, device=codes.device)
    v = torch.zeros((B, ps.numel()), dtype=torch.int64, device=codes.device)
    for j in range(k):
        v = (v << 2) | c[:, ps + j]
    cs = torch.nn.functional.pad(torch.cumsum(d.long(), 1), (1, 0))
    ok = (ps[None, :] <= lens[:, None] - k) & (cs[:, ps + k] == cs[:, ps])
    wide = k > 15
    qh = v >> 30 if wide else v
    ql = v & 0x3FFFFFFF
    kh, kl = _u32(sx.keys_hi), _u32(sx.keys_lo)
    nk = kh.numel()
    lo = torch.zeros_like(v)
    hi = torch.full_like(v, nk)
    for _ in range(sx.steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        m = torch.clamp(mid, max=nk - 1)
        less = kh[m] < qh
        if wide:
            less = less | ((kh[m] == qh) & (kl[m] < ql))
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    ii = torch.clamp(lo, max=nk - 1)
    eq = kh[ii] == qh
    if wide:
        eq = eq & (kl[ii] == ql)
    found = eq & (lo < nk) & ok
    offs = sx.offsets.long()
    occ = torch.where(found, offs[ii + 1] - offs[ii], ALIGN_BIG)
    return (occ.to(torch.int32), found,
            torch.where(found, ii, 0).to(torch.int32))


def sharded_candidates_plain(occ: torch.Tensor, found: torch.Tensor,
                             ii: torch.Tensor, sx: ShardIndex, stride: int,
                             n_seeds: int, C: int, excl_bp: int):
    """The n_seeds rounds of candidate listing on one shard (the owner
    lists positions[offsets[ii] + j] - seed_off in u32, the others 0):
    ((B, n_seeds * C) int32 u32 candidates, bool in range, (B, n_seeds)
    bool owner); for D stacked shards found / ii (D, B, S) and each
    output (D, B, ...)."""
    if shard_count(sx) is not None:
        return _stacked(sx, lambda x, f, i: sharded_candidates_plain(
            occ, f, i, x, stride, n_seeds, C, excl_bp), found, ii)
    B, S = occ.shape
    dev = occ.device
    occ = occ.long()
    ps = torch.arange(S, device=dev) * stride
    cj = torch.arange(C, device=dev)[None, :]
    offs = sx.offsets.long()
    posv = _u32(sx.positions)
    cands, inr, owners = [], [], []
    for _ in range(n_seeds):
        jb = torch.argmin(occ, dim=1)[:, None]
        best = occ.gather(1, jb)[:, 0]
        pb = ps[jb[:, 0]]
        if excl_bp > 0:
            occ = torch.where((ps[None, :] - pb[:, None]).abs() <= excl_bp,
                              ALIGN_BIG, occ)
        else:
            occ = occ.scatter(1, jb, ALIGN_BIG)
        own = found.gather(1, jb)[:, 0]
        base = offs[ii.long().gather(1, jb)[:, 0]]
        ptr = torch.clamp(base[:, None] + cj, 0, posv.numel() - 1)
        cands.append(torch.where(own[:, None],
                                 (posv[ptr] - pb[:, None]) & _M32, 0))
        inr.append(cj < torch.clamp(best, max=C)[:, None])
        owners.append(own)
    return (_to_i32(torch.cat(cands, 1)), torch.cat(inr, 1),
            torch.stack(owners, 1))


def _cand_ok(lengths: torch.Tensor, cand: torch.Tensor,
             in_range: torch.Tensor, owner: torch.Tensor, C: int,
             ref_len: int) -> torch.Tensor:
    """cand_ok of the shard_axis branch: in range, a shard owns the
    round's seed, the read fits and the u32 window ends inside the
    reference."""
    lens = lengths.long()
    return (in_range & owner.repeat_interleave(C, dim=1)
            & (lens <= ref_len)[:, None]
            & (_u32(cand) <= ((ref_len - lens) & _M32)[:, None]))


def sharded_verify_plain(codes: torch.Tensor, lengths: torch.Tensor,
                         cand: torch.Tensor, in_range: torch.Tensor,
                         owner: torch.Tensor, C: int, ref_len: int, c0: int,
                         Cs: int, packed: torch.Tensor, rc: bool,
                         shards: Optional[int] = None):
    """One shard's verify over columns [c0, c0 + Cs) of the candidate list
    padded with zeros: cand_ok, the full window mismatch count, the
    first-index argmin -> ((B,) int32 mis, (B,) int32 u32 window start);
    with ``shards`` = D, shard d on columns [c0 + d Cs, c0 + (d + 1) Cs),
    each output (D, B)."""
    if shards is not None:
        outs = [sharded_verify_plain(codes, lengths, cand, in_range, owner,
                                     C, ref_len, c0 + d * Cs, Cs, packed, rc)
                for d in range(shards)]
        return tuple(torch.stack(x) for x in zip(*outs))
    B, Lp = codes.shape
    lens = lengths.long()
    c = _rc_grid(codes, torch.zeros_like(codes, dtype=torch.bool),
                 lens)[0] if rc else codes.long()
    pos_i = torch.arange(Lp, device=codes.device)[None, :]
    rw, mw = _pack_words(c, pos_i < lens[:, None])
    pad = max(0, c0 + Cs - cand.shape[1])
    ok = torch.nn.functional.pad(
        _cand_ok(lengths, cand, in_range, owner, C, ref_len), (0, pad))
    cs = torch.nn.functional.pad(_u32(cand), (0, pad))[:, c0:c0 + Cs]
    mis = torch.where(ok[:, c0:c0 + Cs],
                      _mis_aligned(_u32(packed), cs, rw, mw,
                                   range(Lp // 16 + 1)), ALIGN_BIG)
    cb = torch.argmin(mis, dim=1)[:, None]
    return (mis.gather(1, cb)[:, 0].to(torch.int32),
            _to_i32(cs.gather(1, cb)[:, 0]))


_STRAND_MODE = {"fwd": 0, "rc": 1, "both": 2}


def sharded_tail_plain(codes: torch.Tensor, dege: torch.Tensor,
                       lengths: torch.Tensor, strand: str, both_strands: int,
                       max_mis: int, k: int, fwd, rev, packed: torch.Tensor):
    """_align_batch's strand choice and mismatch mask from each strand's
    (mis, u32 pos) (None for a strand not run) -> ((B,) bool mapped,
    int32 u32 pos, bool reverse, (B, Lp) bool mask)."""
    B, Lp = codes.shape
    lens = lengths.long()
    pos_i = torch.arange(Lp, device=codes.device)[None, :]
    valid = pos_i < lens[:, None]
    has_dege = (dege & valid).any(1)
    rc = _rc_grid(codes, dege, lens)[0]
    if strand == "fwd":
        use_rev = torch.zeros(B, dtype=torch.bool, device=codes.device)
        mis, pos, eff = fwd[0].long(), _u32(fwd[1]), codes.long()
    elif strand == "rc":
        use_rev = rev[0] <= max_mis
        mis, pos, eff = rev[0].long(), _u32(rev[1]), rc
    else:
        mf, mr = fwd[0].long(), rev[0].long()
        use_rev = (mr < mf) if both_strands else (mf > max_mis)
        mis = torch.where(use_rev, mr, mf)
        pos = torch.where(use_rev, _u32(rev[1]), _u32(fwd[1]))
        eff = torch.where(use_rev[:, None], rc, codes.long())
    mapped = (mis <= max_mis) & ~has_dege & (lens >= k)
    refc = _ref_base_at(_u32(packed), (pos[:, None] + pos_i) & _M32)
    mask = (eff != refc) & valid & mapped[:, None]
    return mapped, _to_i32(pos), use_rev & mapped, mask


def _check_shard(sx: ShardIndex) -> int:
    """The shards in ``sx`` (1 where not stacked)."""
    nd = sx.keys_hi.dim()
    for t, n in ((sx.keys_hi, "keys_hi"), (sx.keys_lo, "keys_lo"),
                 (sx.offsets, "offsets"), (sx.positions, "positions")):
        _check(t, n, torch.int32, nd)
    _check(sx.packed, "packed", torch.int32, 1)
    D = sx.keys_hi.shape[0] if nd == 2 else 1
    kp = sx.keys_hi.shape[-1]
    if (nd not in (1, 2) or sx.keys_lo.shape != sx.keys_hi.shape
            or tuple(sx.offsets.shape) != sx.keys_hi.shape[:-1] + (kp + 1,)
            or (nd == 2 and sx.positions.shape[0] != D)
            or not 1 <= sx.k <= 31):
        raise ValueError("sharded index: shape mismatch")
    return D


def _check_reads(codes, dege, lengths) -> int:
    _check(codes, "codes", torch.uint8, 2)
    _check(dege, "dege", torch.bool, 2)
    _check(lengths, "lengths", torch.int32, 1)
    B, Lp = codes.shape
    if tuple(dege.shape) != (B, Lp) or lengths.numel() != B or Lp % 16:
        raise ValueError("sharded_align: read grid shape mismatch")
    return B


def sharded_lookup(codes: torch.Tensor, dege: torch.Tensor,
                   lengths: torch.Tensor, sx: ShardIndex, stride: int,
                   rc: bool):
    """K19 (a): (B, Lp) uint8 codes, bool degenerate flags, (B,) int32
    lengths, one shard -> ((B, S) int32 occ, bool found, int32 key index
    where found, 0 elsewhere); D stacked shards -> each (D, B, S), one
    launch."""
    if not _on_card(codes, dege, lengths, *sx[:5]):
        return sharded_lookup_plain(codes, dege, lengths, sx, stride, rc)
    B = _check_reads(codes, dege, lengths)
    D = _check_shard(sx)
    S = n_seed_samples(codes.shape[1], sx.k, stride)
    dev = codes.device
    shape = (B, S) if shard_count(sx) is None else (D, B, S)
    occ = torch.empty(shape, dtype=torch.int32, device=dev)
    found = torch.empty(shape, dtype=torch.bool, device=dev)
    ii = torch.empty(shape, dtype=torch.int32, device=dev)
    _launch(_lib().fq_sharded_lookup, "sharded_align", dev, _ptr(codes),
            _ptr(dege), _ptr(lengths), B, codes.shape[1], sx.k, stride, S,
            int(rc), int(sx.k > 15), _ptr(sx.keys_hi), _ptr(sx.keys_lo),
            _ptr(sx.offsets), sx.keys_hi.shape[-1], sx.steps, D, _ptr(occ),
            _ptr(found), _ptr(ii))
    return occ, found, ii


def sharded_candidates(occ: torch.Tensor, found: torch.Tensor,
                       ii: torch.Tensor, sx: ShardIndex, stride: int,
                       n_seeds: int, C: int, excl_bp: int):
    """K19 (b): the global (B, S) int32 occ (after pmin) and this shard's
    found / key index -> ((B, n_seeds * C) int32 u32 candidates, bool in
    range, (B, n_seeds) bool owner); D stacked shards: found / ii and
    each output (D, B, ...), one launch."""
    if not _on_card(occ, found, ii, *sx[:5]):
        return sharded_candidates_plain(occ, found, ii, sx, stride, n_seeds,
                                        C, excl_bp)
    D = _check_shard(sx)
    lead = () if shard_count(sx) is None else (D,)
    _check(occ, "occ", torch.int32, 2)
    _check(found, "found", torch.bool, 2 + len(lead))
    _check(ii, "ii", torch.int32, 2 + len(lead))
    B, S = occ.shape
    if (found.shape != lead + occ.shape or ii.shape != found.shape
            or C < 1):
        raise ValueError("sharded_candidates: shape mismatch")
    dev = occ.device
    cand = torch.empty(lead + (B, n_seeds * C), dtype=torch.int32,
                       device=dev)
    inr = torch.empty(lead + (B, n_seeds * C), dtype=torch.bool, device=dev)
    owner = torch.empty(lead + (B, n_seeds), dtype=torch.bool, device=dev)
    _launch(_lib().fq_sharded_candidates, "sharded_align", dev, _ptr(occ),
            B, S, stride, _ptr(found), _ptr(ii), _ptr(sx.offsets),
            sx.keys_hi.shape[-1], _ptr(sx.positions),
            sx.positions.shape[-1], n_seeds, C, excl_bp, D, _ptr(cand),
            _ptr(inr), _ptr(owner))
    return cand, inr, owner


def sharded_verify(codes: torch.Tensor, lengths: torch.Tensor,
                   cand: torch.Tensor, in_range: torch.Tensor,
                   owner: torch.Tensor, C: int, ref_len: int, c0: int,
                   Cs: int, packed: torch.Tensor, rc: bool,
                   shards: Optional[int] = None):
    """K19 (c): the global (B, n_seeds * C) int32 u32 candidates and bool
    in-range flags, the (B, n_seeds) bool owner bits (after pmax); this
    shard verifies columns [c0, c0 + Cs) of the list padded with zeros ->
    ((B,) int32 mis, (B,) int32 u32 window start); with ``shards`` = D
    the D shards of one device in one launch, shard d on columns
    [c0 + d Cs, c0 + (d + 1) Cs), each output (D, B)."""
    if not _on_card(codes, lengths, cand, in_range, owner, packed):
        return sharded_verify_plain(codes, lengths, cand, in_range, owner,
                                    C, ref_len, c0, Cs, packed, rc, shards)
    _check(codes, "codes", torch.uint8, 2)
    _check(lengths, "lengths", torch.int32, 1)
    _check(cand, "cand", torch.int32, 2)
    _check(in_range, "in_range", torch.bool, 2)
    _check(owner, "owner", torch.bool, 2)
    _check(packed, "packed", torch.int32, 1)
    B, Lp = codes.shape
    if (cand.shape != in_range.shape or cand.shape[0] != B
            or owner.shape[0] != B or cand.shape[1] != owner.shape[1] * C
            or c0 < 0 or Cs < 1 or Lp % 16 or Lp > 1024
            or (shards is not None and shards < 1)
            or not 0 <= ref_len < 1 << 32):
        raise ValueError("sharded_verify: shape mismatch")
    dev = codes.device
    shape = (B,) if shards is None else (shards, B)
    mis = torch.empty(shape, dtype=torch.int32, device=dev)
    pos = torch.empty(shape, dtype=torch.int32, device=dev)
    _launch(_lib().fq_sharded_verify, "sharded_align", dev, _ptr(codes),
            _ptr(lengths), B, Lp, int(rc), _ptr(cand), _ptr(in_range),
            _ptr(owner), owner.shape[1], C, ref_len, c0, Cs, _ptr(packed),
            packed.numel(), shards or 1, _ptr(mis), _ptr(pos))
    return mis, pos


def sharded_tail(codes: torch.Tensor, dege: torch.Tensor,
                 lengths: torch.Tensor, strand: str, both_strands: int,
                 max_mis: int, k: int, fwd, rev, packed: torch.Tensor):
    """K19 (d): each strand's global (mis, u32 pos) ((B,) int32 tensors;
    None for a strand not run) -> ((B,) bool mapped, int32 u32 window
    start, bool reverse strand, (B, Lp) bool mismatch mask)."""
    used = [t for pair in (fwd, rev) if pair is not None for t in pair]
    if not _on_card(codes, dege, lengths, packed, *used):
        return sharded_tail_plain(codes, dege, lengths, strand,
                                  both_strands, max_mis, k, fwd, rev, packed)
    B = _check_reads(codes, dege, lengths)
    _check(packed, "packed", torch.int32, 1)
    mode = _STRAND_MODE[strand]
    if (mode != 1 and fwd is None) or (mode != 0 and rev is None):
        raise ValueError(f"sharded_tail: strand {strand} needs its results")
    for t in used:
        _check(t, "mis/pos", torch.int32, 1)
        if t.numel() != B:
            raise ValueError("sharded_tail: shape mismatch")
    dev = codes.device
    mapped = torch.empty((B,), dtype=torch.bool, device=dev)
    pos = torch.empty((B,), dtype=torch.int32, device=dev)
    is_rev = torch.empty((B,), dtype=torch.bool, device=dev)
    mask = torch.empty(codes.shape, dtype=torch.bool, device=dev)
    f = fwd if fwd is not None else rev
    r = rev if rev is not None else fwd
    _launch(_lib().fq_sharded_tail, "sharded_align", dev, _ptr(codes),
            _ptr(dege), _ptr(lengths), B, codes.shape[1], mode,
            int(both_strands), max_mis, k, _ptr(f[0]), _ptr(f[1]),
            _ptr(r[0]), _ptr(r[1]), _ptr(packed), packed.numel(),
            _ptr(mapped), _ptr(pos), _ptr(is_rev), _ptr(mask))
    return mapped, pos, is_rev, mask
