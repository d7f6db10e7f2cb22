"""The frozen coder's four CUDA kernels, their wrappers and plain versions.

K1 quant_pack          count table -> u16 cumulative table + u32 packed
                       (start, end) words              (engine._quant_full)
K2 frozen_encode_lanes per-lane walk + gather + reverse rANS
                       (engine._device_aux, context_grids, _pass1_frozen,
                       _pass2)
K3 compact_words       emitted words -> dense prefix + count
                       (engine._compact_words)
K4 frozen_decode       one CTA per stream, per-wave lane walk, search,
                       rANS decode and renorm scan (engine._decode_frozen)

The sources are csrc/*.cu with a plain C interface, compiled by nvcc for
sm_90a into one shared library at first use and loaded with ctypes.  A
wrapper takes its plain PyTorch version only for tensors on the CPU; for
a CUDA tensor it launches the kernel or raises.  Every launch adds one to
``LAUNCHES[name]``.

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
from typing import Dict, Tuple

import torch

from fastqueeze_tpu_torch.config import PROB_BITS, RANS_L, RANS_M

LAUNCHES: Dict[str, int] = {"quant_pack": 0, "frozen_encode_lanes": 0,
                            "compact_words": 0, "frozen_decode": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
_LIB_LOCK = threading.Lock()
BUILD_INFO: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _build() -> str:
    """Compile csrc/ into _build/libfqkernels-<content hash>.so (once per
    source content); returns its path.  ptxas register/spill lines land
    in BUILD_INFO["ptxas"]."""
    h = hashlib.sha256()
    for path in _sources():
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"libfqkernels-{h.hexdigest()[:16]}.so")
    log = so + ".log"
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"    # concurrent builders: last wins
        cus = [p for p in _sources() if p.endswith(".cu")]
        r = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-o", tmp] + cus,
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        with open(log, "w") as fh:
            fh.write(r.stderr)
        os.replace(tmp, so)
    ptxas = ""
    if os.path.exists(log):
        with open(log) as fh:
            ptxas = fh.read()
    BUILD_INFO.update(path=so, ptxas=ptxas)
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            spec = [i32] + [i64] * 7
            lib.fq_quant_pack.argtypes = [vp, i64, i32, vp, vp, vp]
            lib.fq_frozen_encode_lanes.argtypes = (
                [vp, vp, i32, i32, i32, vp, i32] + spec + [vp] * 5)
            lib.fq_compact_words.argtypes = [vp, vp, i64, vp, vp, vp, vp]
            lib.fq_frozen_decode.argtypes = (
                [vp, vp, i64, vp, i32, i32, i32, vp, i32] + spec + [vp] * 3)
            lib.fq_decode_lane_bytes.argtypes = []
            lib.fq_decode_lane_bytes.restype = i64
            for fn in (lib.fq_quant_pack, lib.fq_frozen_encode_lanes,
                       lib.fq_compact_words, lib.fq_frozen_decode):
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def build() -> Dict[str, object]:
    """Build (or load) the kernel library now; returns BUILD_INFO."""
    _lib()
    return BUILD_INFO


def _on_card(*tensors: torch.Tensor) -> bool:
    """False: all on the CPU (plain version).  True: all on one CUDA
    device (kernel).  Anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"kernels launch on the current CUDA device, not "
                         f"{dev}")
    return True


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {ndim}-d {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous="
                         f"{t.is_contiguous()}")


def _launch(fn, name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")
    LAUNCHES[name] += 1


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

def quant_pack_plain(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_ctx, A) counts -> ((n_ctx, A+1) int16 cum, (n_ctx*A,) int32
    packed F[s] | F[s+1] << 16)."""
    c = counts.long()
    cs = torch.cumsum(c, dim=1)
    C = torch.clamp(cs[:, -1:], min=1)
    F = torch.cat([torch.zeros_like(C), (cs * RANS_M) // C], dim=1)
    packed = F[:, :-1] | (F[:, 1:] << 16)
    return _to_i16(F), _to_i32(packed.reshape(-1))


def quant_pack(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if not _on_card(counts):
        return quant_pack_plain(counts)
    _check(counts, "counts", torch.int32, 2)
    n, A = counts.shape
    cum = torch.empty((n, A + 1), dtype=torch.int16, device=counts.device)
    packed = torch.empty((n * A,), dtype=torch.int32, device=counts.device)
    _launch(_lib().fq_quant_pack, "quant_pack", _ptr(counts), n, A,
            _ptr(cum), _ptr(packed))
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
    sf = torch.empty((T, L), dtype=torch.int32, device=dev)
    words = torch.empty((T, L), dtype=torch.int16, device=dev)
    emit = torch.empty((T, L), dtype=torch.uint8, device=dev)
    states = torch.empty((L,), dtype=torch.int32, device=dev)
    _launch(_lib().fq_frozen_encode_lanes, "frozen_encode_lanes",
            _ptr(syms), _ptr(cgrid), J, T, L, _ptr(packed), model.alphabet,
            *_spec_args(model), _ptr(sf), _ptr(words), _ptr(emit),
            _ptr(states))
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
    dev = words.device
    tiles = torch.empty(((n + 8191) // 8192,), dtype=torch.int64, device=dev)
    out = torch.empty((n,), dtype=torch.int16, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    _launch(_lib().fq_compact_words, "compact_words", _ptr(words),
            _ptr(emit), n, _ptr(tiles), _ptr(out), _ptr(count))
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
    _launch(lib.fq_frozen_decode, "frozen_decode", _ptr(states0),
            _ptr(words), words.numel(), _ptr(cgrid), cgrid.shape[0], T, L,
            _ptr(cum), A, *_spec_args(model), _ptr(lanes), _ptr(out))
    return out
