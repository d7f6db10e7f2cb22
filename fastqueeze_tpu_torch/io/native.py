"""ctypes bridge to the native C++ FASTQ scanner (native/fqscan.cpp).

The library is built on demand with `make -C native` (g++ is in the image;
pybind11 is not, hence the plain C ABI).  Every entry degrades gracefully:
if the library is missing and cannot be built, callers fall back to the
vectorized-numpy implementations in io/fastq.py.  Set FASTQUEEZE_NO_NATIVE=1
to force the fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libfqnative.so")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _build() -> bool:
    try:
        r = subprocess.run(["make", "-C", _NATIVE_DIR, "-s"],
                           capture_output=True, timeout=120)
        return r.returncode == 0 and os.path.exists(_SO_PATH)
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("FASTQUEEZE_NO_NATIVE"):
        return None
    if not os.path.exists(_SO_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    if not hasattr(lib, "fq_csr_build_wide"):     # newest required symbol
        # stale .so from before a symbol was added (or before the
        # read-sampling rule, a C<->numpy contract, last changed):
        # rebuild and reload
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        if not hasattr(lib, "fq_csr_build_wide"):
            return None
    lib.fq_dup_sources.restype = ctypes.c_int64
    lib.fq_dup_sources.argtypes = [_U8P, _I64P, _I64P, ctypes.c_int64,
                                   _I64P]
    lib.fq_record_boundary.restype = ctypes.c_int64
    lib.fq_record_boundary.argtypes = [_U8P, ctypes.c_int64]
    lib.fq_parse_block.restype = ctypes.c_int64
    lib.fq_parse_block.argtypes = ([_U8P, ctypes.c_int64, ctypes.c_int]
                                   + [_I64P, _I64P, ctypes.c_int64]
                                   + [_I64P] * 8)
    lib.fq_gather.restype = None
    lib.fq_gather.argtypes = [_U8P, _I64P, _I64P, ctypes.c_int64, _U8P]
    lib.fq_scatter.restype = None
    lib.fq_scatter.argtypes = [_U8P, _I64P, _I64P, ctypes.c_int64, _U8P]
    _i32 = ctypes.c_int32
    _u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.rc_encode_ctx.restype = ctypes.c_int64
    lib.rc_encode_ctx.argtypes = [_U8P, _u32p, ctypes.c_int64, _i32, _i32,
                                  _i32, _i32, _i32, _U8P, ctypes.c_int64]
    lib.rc_decode_ctx.restype = ctypes.c_int64
    lib.rc_decode_ctx.argtypes = [_U8P, ctypes.c_int64, _u32p,
                                  ctypes.c_int64, _i32, _i32, _i32, _i32,
                                  _i32, _U8P]
    _i32p = ctypes.POINTER(ctypes.c_int32)
    lib.fq_seq_hist.restype = None
    lib.fq_seq_hist.argtypes = [_U8P, _I64P, ctypes.c_int64, _i32,
                                ctypes.c_uint32, _i32p]
    lib.fq_qual_hist.restype = None
    lib.fq_qual_hist.argtypes = [_U8P, _I64P, ctypes.c_int64, _i32, _i32,
                                 _i32, _i32p]
    lib.fq_train_prefix.restype = ctypes.c_int32
    lib.fq_train_prefix.argtypes = [_U8P, _U8P, _I64P, ctypes.c_int64,
                                    ctypes.c_int64, _i32, ctypes.c_uint32,
                                    _i32, _i32, _i32, _U8P, _i32p, _i32p]
    lib.fq_qctx_hist3.restype = None
    lib.fq_qctx_hist3.argtypes = [_U8P, _I64P, ctypes.c_int64,
                                  ctypes.c_int64, _U8P, _i32, _i32, _i32,
                                  _i32, _i32, _i32, _i32, _i32, _i32p,
                                  _i32p]
    lib.fq_render_dec.restype = ctypes.c_int64
    lib.fq_render_dec.argtypes = [_I64P, ctypes.c_int64, _U8P,
                                  ctypes.c_int64]
    lib.fq_cap_rescale.restype = None
    lib.fq_cap_rescale.argtypes = [_i32p, ctypes.c_int64, _i32, _i32, _i32,
                                   _i32]
    lib.fq_grid_scatter.restype = None
    lib.fq_grid_scatter.argtypes = [_U8P, _i32, _I64P, _I64P, _I64P,
                                    ctypes.c_int64, ctypes.c_int64, _U8P]
    lib.fq_grid_gather.restype = None
    lib.fq_grid_gather.argtypes = [_U8P, _i32, _I64P, _I64P, _I64P,
                                   ctypes.c_int64, ctypes.c_int64, _U8P]
    lib.fq_id_tokenize.restype = ctypes.c_int64
    lib.fq_id_tokenize.argtypes = [_U8P, _I64P, ctypes.c_int64,
                                   ctypes.c_int64, _I64P, _I64P, _I64P]
    _u32p0 = ctypes.POINTER(ctypes.c_uint32)
    lib.fq_csr_build.restype = ctypes.c_int64
    lib.fq_csr_build.argtypes = [_U8P, _U8P, ctypes.c_int64, _i32,
                                 _u32p0, _u32p0, _u32p0, _u32p0]
    _u64p0 = ctypes.POINTER(ctypes.c_uint64)
    lib.fq_csr_build_wide.restype = ctypes.c_int64
    lib.fq_csr_build_wide.argtypes = [_U8P, _U8P, ctypes.c_int64, _i32,
                                      _u64p0, _u32p0, _u64p0, _u32p0]
    lib.rc_encode_o1.restype = ctypes.c_int64
    lib.rc_encode_o1.argtypes = [_U8P, ctypes.c_int64, _i32, _i32, _i32,
                                 _i32, _U8P, ctypes.c_int64]
    lib.rc_decode_o1.restype = ctypes.c_int64
    lib.rc_decode_o1.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64, _i32,
                                 _i32, _i32, _i32, _U8P]
    _u16p = ctypes.POINTER(ctypes.c_uint16)
    _u32p2 = ctypes.POINTER(ctypes.c_uint32)
    lib.fq_quant_table.restype = None
    lib.fq_quant_table.argtypes = [_i32p, ctypes.c_int64, _i32, _u16p]
    lib.fq_frozen_encode.restype = ctypes.c_int64
    lib.fq_frozen_encode.argtypes = [_u16p, _i32, _U8P, _I64P,
                                     ctypes.c_int64, ctypes.c_int64, _i32,
                                     _I64P, _u16p, ctypes.c_int64, _u32p2]
    lib.fq_frozen_decode.restype = ctypes.c_int64
    lib.fq_frozen_decode.argtypes = [_u16p, _i32, _u32p2, _u16p,
                                     ctypes.c_int64, _I64P, ctypes.c_int64,
                                     ctypes.c_int64, _i32, _I64P, _U8P]
    lib.fq_adapt_encode.restype = ctypes.c_int64
    lib.fq_adapt_encode.argtypes = [_i32, ctypes.c_int64, _i32, _i32, _i32,
                                    _U8P, _I64P, ctypes.c_int64,
                                    ctypes.c_int64, _i32, _I64P,
                                    _u16p, ctypes.c_int64, _u32p2]
    lib.fq_adapt_decode.restype = ctypes.c_int64
    lib.fq_adapt_decode.argtypes = [_i32, ctypes.c_int64, _i32, _i32, _i32,
                                    _u32p2, _u16p, ctypes.c_int64, _I64P,
                                    ctypes.c_int64, ctypes.c_int64, _i32,
                                    _I64P, _U8P]
    lib.fq_selfref_align.restype = ctypes.c_int64
    lib.fq_selfref_align.argtypes = [
        _U64P, ctypes.c_int64, _i32p,             # keys (u64), nk, offsets
        _i32p, ctypes.c_int64,                    # positions, npos
        _u32p2, ctypes.c_int64,                   # packed, nw
        _i32p, _i32, _i32,                        # l1, l1_shift, steps
        _i32,                                     # allref_len
        _U8P, _U8P, _I64P, _i32p,                 # codes, dege, roffs, lens
        ctypes.c_int64, _i32,                     # R, lp
        _U8P, _U8P,                               # alignable, is_cand
        _i32, _i32, _i32, _i32,                   # k, stride, c1, c2
        _i32, _i32, _i32, _i32,                   # n_seeds, excl, mis, both
        _U8P, _i32p, _U8P, _U8P]                  # mapped, pos, rev, mm
    _index = [
        _U64P, ctypes.c_int64, _i32p,             # keys (u64), nk, offsets
        _i32p, ctypes.c_int64,                    # positions, npos
        _u32p2, ctypes.c_int64,                   # packed, nw
        _i32p, _i32, _i32,                        # l1, l1_shift, steps
        _i32,                                     # ref_len
        _U8P, _U8P, _I64P, _i32p,                 # codes, dege, roffs, lens
        ctypes.c_int64, _i32,                     # R, lp
        _i32, _i32, _i32, _i32,                   # k, stride, n_cand, max_mis
        _i32, _i32, _i32]                         # n_seeds, excl_bp, probe_k
    lib.fq_align_batch.restype = None
    lib.fq_align_batch.argtypes = _index + [
        _i32, _i32,                               # strand_mode, both_strands
        _U8P, _i32p, _U8P, _U8P]                  # mapped, pos, rev, mis_mask
    lib.fq_indel_batch.restype = None
    lib.fq_indel_batch.argtypes = _index + [
        _i32, _i32,                               # G, ops
        _U8P, _i32p, _i32p, _i32p, _i32p, _i32p,  # found,pos,s1,g1,s2,g2
        _U8P, _U8P]                               # rev, mis_mask
    lib.fq_window_batch.restype = None
    lib.fq_window_batch.argtypes = [
        _u32p2, ctypes.c_int64, _i32,             # packed, nw, ref_len
        _U8P, _U8P, _I64P, _i32p, _i32p,          # codes, dege, roffs, lens,
        ctypes.c_int64, _i32,                     # centers; R, lp
        _i32, _i32,                               # n_cand, max_mis
        _U8P, _i32p, _U8P, _U8P]                  # mapped, pos, rev, mis_mask
    lib.rc_encode_names.restype = ctypes.c_int64
    lib.rc_encode_names.argtypes = [_U8P, _i32p, ctypes.c_int64, _i32, _i32,
                                    _i32, _U8P, ctypes.c_int64]
    lib.rc_decode_names.restype = ctypes.c_int64
    lib.rc_decode_names.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, _i32, _i32, _i32, _U8P,
                                    _i32p]
    for name in ("fq_pack2", "fq_unpack2", "fq_pack6", "fq_unpack6"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [_U8P, ctypes.c_int64, _U8P]
    _LIB = lib
    return _LIB


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def dup_sources(flat: np.ndarray, lens: np.ndarray):
    """(src, n_found) for the duplicate tier, or None when native is
    unavailable (caller falls back to the numpy mirror; bit-identical —
    cross-checked in tests/test_dedup.py)."""
    lib = get_lib()
    if lib is None:
        return None
    f = np.ascontiguousarray(flat, np.uint8)
    ln = np.ascontiguousarray(lens, np.int64)
    R = len(ln)
    offs = np.zeros(R, np.int64)
    if R > 1:
        np.cumsum(ln[:-1], out=offs[1:])
    src = np.empty(R, np.int64)
    n = lib.fq_dup_sources(_u8p(f), _i64p(offs), _i64p(ln), R, _i64p(src))
    return src, int(n)


def csr_build(codes: np.ndarray, amb: np.ndarray, k: int):
    """(kv_sorted u32, pos_sorted u32) for the CSR k-mer index — rolling
    k-mers + stable LSD radix sort in one native pass — or None (caller
    falls back to the numpy argsort path; arrays bit-identical either
    way).  Narrow keys only (k <= 15) and refs under 2^31 windows."""
    lib = get_lib()
    n = len(codes)
    P = n - k + 1
    # positions are u32: references up to 4 G windows build natively
    if lib is None or P <= 0 or P >= (1 << 32) - 1:
        return None
    if k > 15:
        if k > 31:
            return None
        # wide keys (-q tiers): u64 radix variant, bit-identical arrays
        # to the numpy stable-argsort path
        c = np.ascontiguousarray(codes, np.uint8)
        a = np.ascontiguousarray(amb, np.uint8)
        _u = ctypes.POINTER(ctypes.c_uint32)
        _u64 = ctypes.POINTER(ctypes.c_uint64)
        kv = np.empty(P, np.uint64)
        pos = np.empty(P, np.uint32)
        t1 = np.empty(P, np.uint64)
        t2 = np.empty(P, np.uint32)
        m = lib.fq_csr_build_wide(
            _u8p(c), _u8p(a), n, k, kv.ctypes.data_as(_u64),
            pos.ctypes.data_as(_u), t1.ctypes.data_as(_u64),
            t2.ctypes.data_as(_u))
        return kv[:m], pos[:m]
    c = np.ascontiguousarray(codes, np.uint8)
    a = np.ascontiguousarray(amb, np.uint8)
    _u = ctypes.POINTER(ctypes.c_uint32)
    kv = np.empty(P, np.uint32)
    pos = np.empty(P, np.uint32)
    t1 = np.empty(P, np.uint32)
    t2 = np.empty(P, np.uint32)
    m = lib.fq_csr_build(_u8p(c), _u8p(a), n, k,
                         kv.ctypes.data_as(_u), pos.ctypes.data_as(_u),
                         t1.ctypes.data_as(_u), t2.ctypes.data_as(_u))
    return kv[:m], pos[:m]


def record_boundary(data: bytes) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    return int(lib.fq_record_boundary(_u8p(buf), len(buf)))


def parse_spans(buf: np.ndarray, missing_final_nl: bool):
    """Returns dict of 8 span arrays + R, or None when native unavailable
    (caller falls back).  Raises ValueError on malformed FASTQ — the same
    failures the numpy parser reports."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(buf)
    max_lines = int(np.count_nonzero(buf == 10)) + 2
    ls = np.empty(max_lines, np.int64)
    le = np.empty(max_lines, np.int64)
    Rmax = max_lines // 4 + 1
    outs = [np.empty(Rmax, np.int64) for _ in range(8)]
    R = lib.fq_parse_block(_u8p(buf), n, int(missing_final_nl),
                           _i64p(ls), _i64p(le), max_lines,
                           *[_i64p(o) for o in outs])
    if R == -1:
        raise ValueError("FASTQ block line count not divisible by 4")
    if R == -2:
        raise ValueError("record: ID line does not start with '@'")
    if R == -3:
        raise ValueError("malformed FASTQ: '+' line missing")
    if R == -4:
        raise ValueError("seq/qual length mismatch")
    if R < 0:
        raise ValueError(f"native FASTQ parse failed ({R})")
    R = int(R)
    keys = ("id_s", "id_e", "sq_s", "sq_e", "pl_s", "pl_e", "qu_s", "qu_e")
    return {k: o[:R] for k, o in zip(keys, outs)}, R


def gather(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray,
           total: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(total, np.uint8)
    s = np.ascontiguousarray(starts, np.int64)
    e = np.ascontiguousarray(ends, np.int64)
    lib.fq_gather(_u8p(buf), _i64p(s), _i64p(e), len(s), _u8p(out))
    return out


def scatter(flat: np.ndarray, dest_starts: np.ndarray, lens: np.ndarray,
            out: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    f = np.ascontiguousarray(flat, np.uint8)
    d = np.ascontiguousarray(dest_starts, np.int64)
    ln = np.ascontiguousarray(lens, np.int64)
    lib.fq_scatter(_u8p(f), _i64p(d), _i64p(ln), len(d), _u8p(out))
    return True


def _u32p_of(a: Optional[np.ndarray]):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def rc_encode_ctx(syms, ctx, n_ctx, alphabet, init, inc, cap):
    lib = get_lib()
    if lib is None:
        return None
    cap_bytes = len(syms) * 2 + 64
    out = np.empty(cap_bytes, np.uint8)
    n = lib.rc_encode_ctx(_u8p(syms), _u32p_of(ctx), len(syms), n_ctx,
                          alphabet, init, inc, cap, _u8p(out), cap_bytes)
    if n < 0:
        return None
    return out[:n].tobytes()


def rc_decode_ctx(data, n, ctx, n_ctx, alphabet, init, inc, cap):
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.uint8)
    r = lib.rc_decode_ctx(_u8p(buf), len(buf), _u32p_of(ctx), n, n_ctx,
                          alphabet, init, inc, cap, _u8p(out))
    if r < 0:
        return None
    return out


def rc_encode_o1(syms, alphabet, init, inc, cap):
    lib = get_lib()
    if lib is None:
        return None
    cap_bytes = len(syms) * 2 + 64
    out = np.empty(cap_bytes, np.uint8)
    n = lib.rc_encode_o1(_u8p(syms), len(syms), alphabet, init, inc, cap,
                         _u8p(out), cap_bytes)
    if n < 0:
        return None
    return out[:n].tobytes()


def rc_decode_o1(data, n, alphabet, init, inc, cap):
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.uint8)
    r = lib.rc_decode_o1(_u8p(buf), len(buf), n, alphabet, init, inc, cap,
                         _u8p(out))
    if r < 0:
        return None
    return out


def rc_encode_names(cat, lens, init, inc, cap):
    lib = get_lib()
    if lib is None:
        return None
    cap_bytes = int(len(cat) + len(lens)) * 2 + 64
    out = np.empty(cap_bytes, np.uint8)
    lens32 = np.ascontiguousarray(lens, np.int32)
    n = lib.rc_encode_names(_u8p(cat), lens32.ctypes.data_as(_I32P),
                            len(lens32), init, inc, cap, _u8p(out),
                            cap_bytes)
    if n < 0:
        return None
    return out[:n].tobytes()


def rc_decode_names(data, R, total_len, init, inc, cap):
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    cat = np.empty(max(total_len, 1), np.uint8)
    lens = np.empty(max(R, 1), np.int32)
    r = lib.rc_decode_names(_u8p(buf), len(buf), R, total_len, init, inc,
                            cap, _u8p(cat), lens.ctypes.data_as(_I32P))
    if r < 0:
        raise ValueError("corrupt name stream")
    return cat[:total_len], lens[:R]


def seq_hist(codes: np.ndarray, lengths: np.ndarray, order: int,
             magic: int) -> Optional[np.ndarray]:
    """One-pass (context, base) histogram for the frozen-model trainer.
    Returns (n_ctx, 4) int32 raw occurrence counts, or None (fallback)."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int64)
    n_ctx = 1 << (2 * order)
    hist = np.zeros(n_ctx * 4, np.int32)
    lib.fq_seq_hist(_u8p(codes), _i64p(lengths), len(lengths), order,
                    ctypes.c_uint32(magic),
                    hist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return hist.reshape(n_ctx, 4)


def qual_hist(q: np.ndarray, lengths: np.ndarray, qlevel: int,
              drop_init: int, alphabet: int) -> Optional[np.ndarray]:
    """One-pass (context, qual) histogram; (n_ctx, alphabet) int32 or None."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int64)
    n_ctx = (1 << 20) if qlevel >= 3 else (1 << 16)
    hist = np.zeros(n_ctx * alphabet, np.int32)
    lib.fq_qual_hist(_u8p(q), _i64p(lengths), len(lengths), qlevel,
                     drop_init, alphabet,
                     hist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return hist.reshape(n_ctx, alphabet)


def pack_grid(grid: np.ndarray, bits: int) -> Optional[np.ndarray]:
    """(T, L) u8 grid -> packed bytes, 4 symbols a group: bits=2 packs to
    1 byte a group, bits=6 to 3 (the transfer packs of ops/engine.py).
    None -> numpy fallback."""
    lib = get_lib()
    if lib is None:
        return None
    T, L = grid.shape
    n = T * (L // 4)
    grid = np.ascontiguousarray(grid, np.uint8)
    out = np.empty(n * (1 if bits == 2 else 3), np.uint8)
    (lib.fq_pack2 if bits == 2 else lib.fq_pack6)(_u8p(grid), n, _u8p(out))
    return out.reshape(T, (L // 4) * (1 if bits == 2 else 3))


def unpack_grid(packed: np.ndarray, bits: int) -> Optional[np.ndarray]:
    """Inverse of :func:`pack_grid`; None -> numpy fallback."""
    lib = get_lib()
    if lib is None:
        return None
    T, W = packed.shape
    groups = W if bits == 2 else W // 3       # 4-symbol groups a row
    packed = np.ascontiguousarray(packed, np.uint8)
    out = np.empty(T * groups * 4, np.uint8)
    (lib.fq_unpack2 if bits == 2 else lib.fq_unpack6)(
        _u8p(packed), T * groups, _u8p(out))
    return out.reshape(T, groups * 4)


def render_dec(vals: np.ndarray) -> Optional[bytes]:
    """b"%d\\n"-rendering of an int64 vector in one C pass, or None."""
    lib = get_lib()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, np.int64)
    cap = len(vals) * 22 + 1
    out = np.empty(cap, np.uint8)
    w = lib.fq_render_dec(_i64p(vals), len(vals), _u8p(out), cap)
    if w < 0:
        return None
    return out[:w].tobytes()


def train_prefix(seq_flat: np.ndarray, qual_flat: np.ndarray,
                 lengths: np.ndarray, stride: int, order: int, magic: int,
                 qlevel: int, drop_init: int, qlut: np.ndarray,
                 alphabet: int):
    """Fused frozen-model trainer over RAW ASCII seq/qual: stride
    subsample + base map + degenerate strip + qual remap (qlut: raw char
    -> coded symbol) + both histograms in one C pass.  Returns
    (seq_hist (n_ctx,4), qual_hist (n_qctx,alphabet)) or None
    (fallback to the numpy path)."""
    lib = get_lib()
    if lib is None:
        return None
    seq_flat = np.ascontiguousarray(seq_flat, np.uint8)
    qual_flat = np.ascontiguousarray(qual_flat, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int64)
    qlut = np.ascontiguousarray(qlut, np.uint8)
    n_ctx = 1 << (2 * order)
    n_qctx = (1 << 20) if qlevel >= 3 else (1 << 16)
    shist = np.zeros(n_ctx * 4, np.int32)
    qhist = np.zeros(n_qctx * alphabet, np.int32)
    _p = ctypes.POINTER(ctypes.c_int32)
    lib.fq_train_prefix(_u8p(seq_flat), _u8p(qual_flat), _i64p(lengths),
                        len(lengths), stride, order,
                        ctypes.c_uint32(magic), qlevel, drop_init,
                        alphabet, _u8p(qlut), shist.ctypes.data_as(_p),
                        qhist.ctypes.data_as(_p))
    return shist.reshape(n_ctx, 4), qhist.reshape(n_qctx, alphabet)


def qctx_hist(qual: np.ndarray, lengths: np.ndarray, stride: int,
              qlut: np.ndarray, alphabet: int, k: int, cbase: int,
              drop_bits: int, pos_bits: int, drop_init: int,
              hash_bits: int = 0, qlevel: int = 1,
              n_ctx: int = 0, holdout: bool = False):
    """Quality-context histogram (frozen-train candidate scheme): rank
    chains (k >= 2) or the fqzcomp formula (k < 2, pass n_ctx + qlevel).
    Returns (n_ctx, alphabet) int32, or with holdout=True the pair
    (full_hist, odd_parity_half_hist) — the hash-parity holdout split
    of frozen._select_qctx — or None (numpy fallback)."""
    lib = get_lib()
    if lib is None:
        return None
    qual = np.ascontiguousarray(qual, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int64)
    qlut = np.ascontiguousarray(qlut, np.uint8)
    if not n_ctx:
        rows = (1 << hash_bits) if hash_bits else cbase ** k
        n_ctx = rows << (drop_bits + pos_bits)
    hist = np.zeros(n_ctx * alphabet, np.int32)
    _p = ctypes.POINTER(ctypes.c_int32)
    hist_b = np.zeros(n_ctx * alphabet, np.int32) if holdout else None
    lib.fq_qctx_hist3(_u8p(qual), _i64p(lengths), len(lengths), stride,
                      _u8p(qlut), alphabet, k, cbase, drop_bits, pos_bits,
                      hash_bits, drop_init, qlevel,
                      hist.ctypes.data_as(_p),
                      hist_b.ctypes.data_as(_p) if holdout else None)
    if holdout:
        return (hist.reshape(n_ctx, alphabet),
                hist_b.reshape(n_ctx, alphabet))
    return hist.reshape(n_ctx, alphabet)


def cap_rescale(hist: np.ndarray, inc: int, init: int,
                cap: int) -> Optional[np.ndarray]:
    """In-place inc/init weighting + cap rescale of a (n_ctx, A) int32
    histogram; returns the same array, or None (fallback)."""
    lib = get_lib()
    if lib is None:
        return None
    assert hist.dtype == np.int32 and hist.flags.c_contiguous
    lib.fq_cap_rescale(
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hist.shape[0], hist.shape[1], inc, init, cap)
    return hist


def grid_scatter(flat: np.ndarray, counts: np.ndarray, start_t: np.ndarray,
                 lane: np.ndarray, grid: np.ndarray) -> bool:
    """Scatter ragged read-major flat symbols into a (T, L) grid (in place).
    flat/grid itemsize must be 1 or 2.  Returns False (fallback) if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None or flat.dtype.itemsize not in (1, 2):
        return False
    assert grid.flags.c_contiguous and grid.dtype.itemsize == flat.dtype.itemsize
    f = np.ascontiguousarray(flat)
    c = np.ascontiguousarray(counts, np.int64)
    s = np.ascontiguousarray(start_t, np.int64)
    ln = np.ascontiguousarray(lane, np.int64)
    lib.fq_grid_scatter(f.ctypes.data_as(_U8P), flat.dtype.itemsize,
                        _i64p(c), _i64p(s), _i64p(ln), len(c),
                        grid.shape[1], grid.ctypes.data_as(_U8P))
    return True


def grid_gather(grid: np.ndarray, counts: np.ndarray, start_t: np.ndarray,
                lane: np.ndarray, flat: np.ndarray) -> bool:
    """Gather a (T, L) grid back into ragged read-major flat (in place)."""
    lib = get_lib()
    if lib is None or grid.dtype.itemsize not in (1, 2):
        return False
    assert grid.flags.c_contiguous and flat.dtype.itemsize == grid.dtype.itemsize
    g = np.ascontiguousarray(grid)
    c = np.ascontiguousarray(counts, np.int64)
    s = np.ascontiguousarray(start_t, np.int64)
    ln = np.ascontiguousarray(lane, np.int64)
    lib.fq_grid_gather(g.ctypes.data_as(_U8P), grid.dtype.itemsize,
                       _i64p(c), _i64p(s), _i64p(ln), len(c),
                       g.shape[1], flat.ctypes.data_as(_U8P))
    return True


_U16P = ctypes.POINTER(ctypes.c_uint16)
_U32P = ctypes.POINTER(ctypes.c_uint32)


def madvise_hugepage(a: np.ndarray) -> None:
    """MADV_HUGEPAGE the array's pages (no-op on failure).  The deep-qctx
    cum tables are 20-170 MB walked by per-symbol random gathers — with
    the box's madvise-only THP policy numpy allocations sit on 4 KB pages
    and the walk is dTLB-miss bound; 2 MB pages cut the table to < 100
    TLB entries.  Call BEFORE first touch so the fill faults huge pages
    in directly (khugepaged collapses later touches anyway)."""
    try:
        import mmap as _mmap
        page = _mmap.PAGESIZE
        addr = a.ctypes.data
        end = addr + a.nbytes
        start = (addr + page - 1) & ~(page - 1)
        length = (end - start) & ~(page - 1)
        if length >= (4 << 20):
            libc = ctypes.CDLL(None, use_errno=True)
            libc.madvise(ctypes.c_void_p(start), ctypes.c_size_t(length),
                         14)                      # MADV_HUGEPAGE
    except Exception:
        pass


def quant_table(counts: np.ndarray) -> Optional[np.ndarray]:
    """(n_ctx, A) int32 counts -> (n_ctx, A+1) u16 cumfreqs summing to 2^14
    (bit-identical to engine._quant).  None -> native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, np.int32)
    n_ctx, A = counts.shape
    cum = np.empty((n_ctx, A + 1), np.uint16)
    madvise_hugepage(cum)       # before first touch: fill faults 2MB pages
    lib.fq_quant_table(counts.ctypes.data_as(_I32P), n_ctx, A,
                       cum.ctypes.data_as(_U16P))
    return cum


def frozen_encode(cum: np.ndarray, A: int, syms: np.ndarray,
                  counts: np.ndarray, L: int, kind: int, spec: np.ndarray):
    """Host-native frozen wave-rANS encode (bit-identical to the device
    engine).  Returns (words u16, states u32) or None (unavailable)."""
    lib = get_lib()
    if lib is None:
        return None
    cum = np.ascontiguousarray(cum, np.uint16)
    syms = np.ascontiguousarray(syms, np.uint8)
    counts = np.ascontiguousarray(counts, np.int64)
    spec = np.ascontiguousarray(spec, np.int64)
    cap = len(syms) + 8
    words = np.empty(cap, np.uint16)
    states = np.empty(L, np.uint32)
    n = lib.fq_frozen_encode(cum.ctypes.data_as(_U16P), A, _u8p(syms),
                             _i64p(counts), len(counts), L, kind,
                             _i64p(spec), words.ctypes.data_as(_U16P), cap,
                             states.ctypes.data_as(_U32P))
    if n < 0:
        return None
    return words[:n], states


def frozen_decode(cum: np.ndarray, A: int, states: np.ndarray,
                  words: np.ndarray, counts: np.ndarray, L: int, kind: int,
                  spec: np.ndarray, nsym: int) -> Optional[np.ndarray]:
    """Inverse of frozen_encode -> read-major flat symbols, or None."""
    lib = get_lib()
    if lib is None:
        return None
    cum = np.ascontiguousarray(cum, np.uint16)
    states = np.ascontiguousarray(states, np.uint32)
    words = np.ascontiguousarray(words, np.uint16)
    counts = np.ascontiguousarray(counts, np.int64)
    spec = np.ascontiguousarray(spec, np.int64)
    out = np.empty(max(nsym, 1), np.uint8)
    r = lib.fq_frozen_decode(cum.ctypes.data_as(_U16P), A,
                             states.ctypes.data_as(_U32P),
                             words.ctypes.data_as(_U16P), len(words),
                             _i64p(counts), len(counts), L, kind,
                             _i64p(spec), _u8p(out))
    if r < 0:
        return None
    return out[:nsym]


def adapt_encode(A: int, n_ctx: int, init: int, inc: int, cap: int,
                 syms: np.ndarray, counts: np.ndarray, L: int, kind: int,
                 spec: np.ndarray):
    """Host-native ADAPTIVE wave-rANS encode (bit-identical to the device
    engine's per-wave adaptive path).  Returns (words u16, states u32) or
    None (unavailable)."""
    lib = get_lib()
    if lib is None:
        return None
    syms = np.ascontiguousarray(syms, np.uint8)
    counts = np.ascontiguousarray(counts, np.int64)
    spec = np.ascontiguousarray(spec, np.int64)
    wcap = len(syms) + 8
    words = np.empty(wcap, np.uint16)
    states = np.empty(L, np.uint32)
    n = lib.fq_adapt_encode(A, n_ctx, init, inc, cap, _u8p(syms),
                            _i64p(counts), len(counts), L, kind,
                            _i64p(spec), words.ctypes.data_as(_U16P), wcap,
                            states.ctypes.data_as(_U32P))
    if n < 0:
        return None
    return words[:n], states


def adapt_decode(A: int, n_ctx: int, init: int, inc: int, cap: int,
                 states: np.ndarray, words: np.ndarray, counts: np.ndarray,
                 L: int, kind: int, spec: np.ndarray,
                 nsym: int) -> Optional[np.ndarray]:
    """Inverse of adapt_encode -> read-major flat symbols, or None."""
    lib = get_lib()
    if lib is None:
        return None
    states = np.ascontiguousarray(states, np.uint32)
    words = np.ascontiguousarray(words, np.uint16)
    counts = np.ascontiguousarray(counts, np.int64)
    spec = np.ascontiguousarray(spec, np.int64)
    out = np.empty(max(nsym, 1), np.uint8)
    r = lib.fq_adapt_decode(A, n_ctx, init, inc, cap,
                            states.ctypes.data_as(_U32P),
                            words.ctypes.data_as(_U16P), len(words),
                            _i64p(counts), len(counts), L, kind,
                            _i64p(spec), _u8p(out))
    if r < 0:
        return None
    return out[:nsym]


def id_tokenize(buf: np.ndarray, offs: np.ndarray, cap: int):
    """Tokenize concatenated ID lines into digit/non-digit runs.  Returns
    (ntok (R,), tstart (M,), tend (M,)) or None (unavailable / cap hit)."""
    lib = get_lib()
    if lib is None:
        return None
    R = len(offs) - 1
    ntok = np.empty(R, np.int64)
    tstart = np.empty(cap, np.int64)
    tend = np.empty(cap, np.int64)
    offs = np.ascontiguousarray(offs, np.int64)
    m = lib.fq_id_tokenize(_u8p(buf), _i64p(offs), R, cap, _i64p(ntok),
                           _i64p(tstart), _i64p(tend))
    if m < 0:
        return None
    return ntok, tstart[:m], tend[:m]


def selfref_align(keys: np.ndarray, offsets: np.ndarray,
                  positions: np.ndarray, packed: np.ndarray,
                  l1: np.ndarray, l1_shift: int, search_steps: int,
                  allref_len: int, codes_flat: np.ndarray,
                  dege_flat: np.ndarray, roffs: np.ndarray,
                  lengths: np.ndarray, lp: int,
                  alignable: np.ndarray, is_cand: np.ndarray,
                  k: int, stride: int, c1: int, c2: int,
                  n_seeds: int, excl_bp: int, max_mis: int,
                  both_strands: int):
    """One-pass self-referential aligner (native/alignhost.cpp
    fq_selfref_align): reads map only to windows inside EARLIER
    still-kept candidate reads' spans; positions come back in FINAL
    reference coordinates.  Mirror: pipeline/selfref._selfref_align_py
    (cross-checked in tests/test_selfref.py).  Returns (mapped, pos,
    is_rev, mis_mask) or None when native is unavailable."""
    lib = get_lib()
    if lib is None or keys.dtype != np.uint64:
        return None
    R = len(roffs)
    keys = np.ascontiguousarray(keys, np.uint64)
    offsets = np.ascontiguousarray(offsets, np.int32)
    positions = np.ascontiguousarray(positions, np.int32)
    packed = np.ascontiguousarray(packed, np.uint32)
    l1 = np.ascontiguousarray(l1, np.int32)
    codes_flat = np.ascontiguousarray(codes_flat, np.uint8)
    dege_flat = np.ascontiguousarray(dege_flat.astype(np.uint8))
    roffs = np.ascontiguousarray(roffs, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int32)
    alignable = np.ascontiguousarray(alignable.astype(np.uint8))
    is_cand = np.ascontiguousarray(is_cand.astype(np.uint8))
    mapped = np.empty(R, np.uint8)
    pos = np.empty(R, np.int32)
    rev = np.empty(R, np.uint8)
    mm = np.empty((R, lp), np.uint8)
    lib.fq_selfref_align(
        keys.ctypes.data_as(_U64P), len(keys),
        offsets.ctypes.data_as(_I32P),
        positions.ctypes.data_as(_I32P), len(positions),
        packed.ctypes.data_as(_U32P), len(packed),
        l1.ctypes.data_as(_I32P), l1_shift, search_steps, allref_len,
        _u8p(codes_flat), _u8p(dege_flat), _i64p(roffs),
        lengths.ctypes.data_as(_I32P), R, lp,
        _u8p(alignable), _u8p(is_cand),
        k, stride, c1, c2, n_seeds, excl_bp, max_mis, both_strands,
        _u8p(mapped), pos.ctypes.data_as(_I32P), _u8p(rev), _u8p(mm))
    return mapped.astype(bool), pos, rev.astype(bool), mm.astype(bool)


# Calls of the native host aligner (fq_align_batch / fq_indel_batch /
# fq_window_batch), so a run can show that nothing on the card's path
# aligned on the host.
ALIGN_CALLS = {"align_batch": 0, "indel_batch": 0, "window_batch": 0}


def _index_args(keys, offsets, positions, packed, l1, l1_shift,
                search_steps, ref_len, codes_flat, dege_flat, roffs,
                lengths, lp, k, stride, n_cand, max_mis, n_seeds, excl_bp,
                probe_k):
    """The argument prefix fq_align_batch and fq_indel_batch share, with
    every array made contiguous in the type the C side reads (the arrays
    are returned too, so they outlive the call)."""
    arrs = (np.ascontiguousarray(keys, np.uint64),
            np.ascontiguousarray(offsets, np.int32),
            np.ascontiguousarray(positions, np.int32),
            np.ascontiguousarray(packed, np.uint32),
            np.ascontiguousarray(l1, np.int32),
            np.ascontiguousarray(codes_flat, np.uint8),
            np.ascontiguousarray(dege_flat.astype(np.uint8)),
            np.ascontiguousarray(roffs, np.int64),
            np.ascontiguousarray(lengths, np.int32))
    keys, offsets, positions, packed, l1, codes, dege, roffs, lens = arrs
    args = [keys.ctypes.data_as(_U64P), len(keys),
            offsets.ctypes.data_as(_I32P),
            positions.ctypes.data_as(_I32P), len(positions),
            packed.ctypes.data_as(_U32P), len(packed),
            l1.ctypes.data_as(_I32P), l1_shift, search_steps, ref_len,
            _u8p(codes), _u8p(dege), _i64p(roffs),
            lens.ctypes.data_as(_I32P), len(roffs), lp,
            k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k]
    return args, arrs


def align_batch(keys: np.ndarray, offsets: np.ndarray,
                positions: np.ndarray, packed: np.ndarray, l1: np.ndarray,
                l1_shift: int, search_steps: int, ref_len: int,
                codes_flat: np.ndarray, dege_flat: np.ndarray,
                roffs: np.ndarray, lengths: np.ndarray, lp: int,
                k: int, stride: int, n_cand: int, max_mis: int,
                n_seeds: int, excl_bp: int, probe_k: int,
                strand_mode: int, both_strands: int):
    """Host-native gapless aligner (native/alignhost.cpp fq_align_batch),
    a decision mirror of fastqueeze_tpu/align/hash.py _align_batch.
    codes_flat/dege_flat are the block's flat arrays; roffs/lengths pick
    the tier's reads; ``packed`` must carry lp/16 + 2 zero words past the
    reference.  Returns (mapped bool, pos int32, is_rev bool, mis_mask
    (R, lp) bool); raises when the library is missing."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the host aligner needs the native library "
                           "(make -C native)")
    args, _keep = _index_args(keys, offsets, positions, packed, l1, l1_shift,
                              search_steps, ref_len, codes_flat, dege_flat,
                              roffs, lengths, lp, k, stride, n_cand, max_mis,
                              n_seeds, excl_bp, probe_k)
    R = len(roffs)
    mapped = np.empty(R, np.uint8)
    pos = np.empty(R, np.int32)
    rev = np.empty(R, np.uint8)
    mm = np.empty((R, lp), np.uint8)
    lib.fq_align_batch(*args, strand_mode, both_strands, _u8p(mapped),
                       pos.ctypes.data_as(_I32P), _u8p(rev), _u8p(mm))
    ALIGN_CALLS["align_batch"] += 1
    return mapped.astype(bool), pos, rev.astype(bool), mm.astype(bool)


def indel_batch(keys: np.ndarray, offsets: np.ndarray,
                positions: np.ndarray, packed: np.ndarray, l1: np.ndarray,
                l1_shift: int, search_steps: int, ref_len: int,
                codes_flat: np.ndarray, dege_flat: np.ndarray,
                roffs: np.ndarray, lengths: np.ndarray, lp: int,
                k: int, stride: int, n_cand: int, max_mis: int,
                n_seeds: int, excl_bp: int, probe_k: int, G: int,
                ops: int = 2):
    """Host-native indel tier, up to ``ops`` gap operations a read
    (native/alignhost.cpp fq_indel_batch), a decision mirror of
    fastqueeze_tpu/align/hash.py _indel_batch.  Returns (found bool, pos,
    split, gap, split2, gap2 int32, is_rev bool, mis_mask (R, lp) bool);
    raises when the library is missing."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the host aligner needs the native library "
                           "(make -C native)")
    args, _keep = _index_args(keys, offsets, positions, packed, l1, l1_shift,
                              search_steps, ref_len, codes_flat, dege_flat,
                              roffs, lengths, lp, k, stride, n_cand, max_mis,
                              n_seeds, excl_bp, probe_k)
    R = len(roffs)
    found = np.empty(R, np.uint8)
    out = [np.empty(R, np.int32) for _ in range(5)]
    rev = np.empty(R, np.uint8)
    mm = np.empty((R, lp), np.uint8)
    lib.fq_indel_batch(*args, G, ops, _u8p(found),
                       *(o.ctypes.data_as(_I32P) for o in out), _u8p(rev),
                       _u8p(mm))
    ALIGN_CALLS["indel_batch"] += 1
    return (found.astype(bool), *out, rev.astype(bool), mm.astype(bool))


def window_batch(packed: np.ndarray, ref_len: int, codes_flat: np.ndarray,
                 dege_flat: np.ndarray, roffs: np.ndarray,
                 lengths: np.ndarray, centers: np.ndarray, lp: int,
                 n_cand: int, max_mis: int):
    """Host-native anchored window verification (native/alignhost.cpp
    fq_window_batch), a decision mirror of fastqueeze_tpu/align/hash.py
    _window_batch (PE mate rescue): each read is verified at every offset
    in [center - n_cand/2, center + n_cand/2), both strands.  ``packed``
    must be the padded host copy.  Returns (mapped bool, pos int32, is_rev
    bool, mis_mask (R, lp) bool); raises when the library is missing."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the host aligner needs the native library "
                           "(make -C native)")
    R = len(roffs)
    packed = np.ascontiguousarray(packed, np.uint32)
    codes_flat = np.ascontiguousarray(codes_flat, np.uint8)
    dege_flat = np.ascontiguousarray(dege_flat.astype(np.uint8))
    roffs = np.ascontiguousarray(roffs, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int32)
    centers = np.ascontiguousarray(centers, np.int32)
    mapped = np.empty(R, np.uint8)
    pos = np.empty(R, np.int32)
    rev = np.empty(R, np.uint8)
    mm = np.empty((R, lp), np.uint8)
    lib.fq_window_batch(
        packed.ctypes.data_as(_U32P), len(packed), ref_len,
        _u8p(codes_flat), _u8p(dege_flat), _i64p(roffs),
        lengths.ctypes.data_as(_I32P), centers.ctypes.data_as(_I32P),
        R, lp, n_cand, max_mis,
        _u8p(mapped), pos.ctypes.data_as(_I32P), _u8p(rev), _u8p(mm))
    ALIGN_CALLS["window_batch"] += 1
    return mapped.astype(bool), pos, rev.astype(bool), mm.astype(bool)
