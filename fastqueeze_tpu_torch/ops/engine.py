"""Wave-rANS engine (frozen and adaptive coders), in PyTorch + CUDA.

Counterpart of fastqueeze_tpu/ops/engine.py; the wire format is the same:

    header(T, L, n_words, n_symbols) | L x u32 final states | words u16[]

``L`` lanes (32-bit rANS state, 16-bit renormalization words, 14-bit
frequencies) code symbol waves in lockstep; lane l codes reads l, l+L,
l+2L, ... (ops/lanes.py).  Frozen coder (usemodel): frequencies come
from a frozen count table, quantized once per table and device (K1);
encode is K2 (per-lane walk, gather, reverse rANS) then K3 (compaction
of the emitted words into canonical (wave, lane) order); decode is K4.
Adaptive coder
(``adapt=True``): every stream starts from a fresh table (``init`` in
every cell) or from ``counts0`` (a frozen table that keeps adapting,
``frozen_adapt``), which all lanes update after every wave; encode is K5
(the forward walk) then K7 (reverse rANS) then K3, decode is K6.  With
``params.adapt_chunk`` dividing the wave count (and no caller-supplied
contexts) the table is instead requantized every adapt_chunk waves, the
semi-adaptive walk: encode is K11 then K7 then K3, decode is K12.
:func:`train_counts` trains a frozen table on the device (K13).  Symbol
grids cross the host link packed (the transfer packs: K15 unpacks the
uploaded grid, K16 and, for 6-bit grids, K17 pack the decoded one); the
frozen tables travel in the narrow type they were trained in (K1 reads
u8, u16 or i32).  See ops/kernels.py.

Each job is split into a dispatch (kernels queued on the current CUDA
stream) and ``finalize()``, which synchronizes and serializes, so a
caller can do host work for other streams in between.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.io import native
from fastqueeze_tpu_torch.ops import kernels
from fastqueeze_tpu_torch.ops.lanes import from_grid, make_layout, to_grid

_HDR = struct.Struct("<IIII")  # T, L, n_words, n_symbols


@dataclass
class FrozenTable:
    """One frozen count table quantized on one device (K1 output)."""
    cum: torch.Tensor       # (n_ctx, A+1) int16: u16 cumulative freqs
    packed: torch.Tensor    # (n_ctx*A,) int32: u32 F[s] | F[s+1] << 16

    @property
    def device(self) -> torch.device:
        return self.cum.device


def frozen_table(counts: np.ndarray, device) -> FrozenTable:
    """Upload a (n_ctx, A) count table in the type it travels in (u8 or
    u16 for trained frozen tables, else int32) and quantize it there (K1
    reads all three: the counterpart of the reference's counts0_dev)."""
    c = np.ascontiguousarray(counts)
    if c.dtype not in (np.uint8, np.uint16):
        c = np.ascontiguousarray(c, np.int32)
    elif not c.flags.writeable:            # a view of an archive's bytes
        c = c.copy()
    t = torch.from_numpy(c.view(np.int16) if c.dtype == np.uint16 else c)
    return FrozenTable(*kernels.quant_pack(t.to(device)))


def resolve_device(device) -> torch.device:
    """torch.device with the CUDA index filled in ("cuda" -> "cuda:N")."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _as_table(counts0: Union[FrozenTable, np.ndarray, None], device):
    if counts0 is None:
        raise ValueError("frozen coding needs a counts table")
    if isinstance(counts0, FrozenTable):
        if counts0.device != resolve_device(device):
            raise ValueError(f"table on {counts0.device}, engine on {device}")
        return counts0
    return frozen_table(np.asarray(counts0), device)


def _counts_grid(counts_per_read: np.ndarray, L: int) -> np.ndarray:
    """(R,) read lengths -> (ceil(R/L), L) round-robin slot grid (read r at
    slot (r // L, r % L))."""
    R = len(counts_per_read)
    J = max(1, (R + L - 1) // L)
    pad = np.zeros(J * L, np.int32)
    pad[:R] = counts_per_read
    return pad.reshape(J, L)


def _n_halve(model, L: int) -> int:
    """Halvings that bring any post-wave row total (<= cap + inc * L + A)
    back under cap (fastqueeze_tpu/ops/engine.py _n_halve)."""
    worst = model.cap + model.inc * L + model.alphabet
    return max(1, math.ceil(math.log2(worst / model.cap)) + 1)


def _chunk_of(params: CodecParams, T: int) -> int:
    """Semi-adaptive chunk: params.adapt_chunk when it divides the wave
    count, else 0 (per-wave adaptation); a function of serialized params
    and layout, so encode and decode agree (fastqueeze_tpu/ops/engine.py
    _chunk_of)."""
    c = params.adapt_chunk
    return c if (c and T % c == 0) else 0


def _n_halve_chunk(model, L: int, chunk: int) -> int:
    """Halvings that bring any row total after a chunk of ``chunk`` waves
    back under cap (fastqueeze_tpu/ops/engine.py _n_halve_chunk)."""
    worst = model.cap + model.inc * L * chunk + model.alphabet
    return max(1, math.ceil(math.log2(worst / model.cap)) + 1)


def _adapt_counts0(counts0, device) -> Optional[torch.Tensor]:
    """The adaptive walk's starting table on ``device``: None (fresh), a
    numpy table, or an int32 tensor already there (the walks copy it)."""
    if counts0 is None:
        return None
    if isinstance(counts0, FrozenTable):
        raise ValueError("adaptive coding starts from raw counts, not a "
                         "quantized FrozenTable")
    if not isinstance(counts0, torch.Tensor):
        counts0 = torch.tensor(np.asarray(counts0), dtype=torch.int32)
    elif counts0.device.type != "cpu" and counts0.device != resolve_device(
            device):
        raise ValueError(f"table on {counts0.device}, engine on {device}")
    return counts0.to(device=device, dtype=torch.int32)


# --- transfer packs (host side) ---------------------------------------------
#
# A stream's (T, L) symbol grid crosses the host link packed (the
# reference's transfer packs; the bitstream never sees them): encode and
# the trainer pack on the host and unpack on the device (K15), decode
# packs on the device (K16, and K17 for 6-bit grids) and unpacks on the
# host.  Streams with caller-supplied contexts (FlatModel) travel unpacked,
# as in the reference.

_EXC_SYM = 15


def _pack_mode(model, L: int) -> int:
    """0 = none, else the bits a symbol of the dense pack (2, 4, 6)."""
    if L % 4:
        return 0
    if model.alphabet <= 4:
        return 2
    if model.alphabet <= 16:
        return 4
    if model.alphabet <= 64:
        return 6
    return 0


def _exc_bucket(n: int) -> int:
    """The sidecar's exception slots: powers of 4 from 1024 (the
    reference's compile-variant bucket; the pack choice below charges
    the padding)."""
    cap = 1024
    while cap < n:
        cap <<= 2
    return cap


def _pack2_host(grid: np.ndarray) -> np.ndarray:
    out = native.pack_grid(grid, 2)
    if out is not None:
        return out
    T, L = grid.shape
    g = grid.reshape(T, L // 4, 4).astype(np.uint8)
    return (g[:, :, 0] | (g[:, :, 1] << 2) | (g[:, :, 2] << 4)
            | (g[:, :, 3] << 6))


def _unpack2_host(packed: np.ndarray) -> np.ndarray:
    out = native.unpack_grid(packed, 2)
    if out is not None:
        return out
    T, Lq = packed.shape
    parts = np.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], axis=2)
    return parts.reshape(T, Lq * 4)


def _pack4_host(grid: np.ndarray) -> np.ndarray:
    T, L = grid.shape
    g = grid.reshape(T, L // 2, 2)
    return g[:, :, 0] | (g[:, :, 1] << 4)


def _unpack4_host(packed: np.ndarray) -> np.ndarray:
    T, Lh = packed.shape
    out = np.empty((T, Lh * 2), np.uint8)
    out[:, 0::2] = packed & 15
    out[:, 1::2] = packed >> 4
    return out


def _pack6_host(grid: np.ndarray) -> np.ndarray:
    out = native.pack_grid(grid, 6)
    if out is not None:
        return out
    T, L = grid.shape
    g = grid.reshape(T, L // 4, 4).astype(np.uint32)
    v = g[:, :, 0] | (g[:, :, 1] << 6) | (g[:, :, 2] << 12) | (g[:, :, 3] << 18)
    out = np.empty((T, L // 4, 3), np.uint8)
    out[:, :, 0] = v & 0xFF
    out[:, :, 1] = (v >> 8) & 0xFF
    out[:, :, 2] = (v >> 16) & 0xFF
    return out.reshape(T, (L // 4) * 3)


def _unpack6_host(packed: np.ndarray) -> np.ndarray:
    out = native.unpack_grid(packed, 6)
    if out is not None:
        return out
    T, L3 = packed.shape
    q = L3 // 3
    p3 = packed.reshape(T, q, 3).astype(np.uint32)
    v = p3[:, :, 0] | (p3[:, :, 1] << 8) | (p3[:, :, 2] << 16)
    parts = np.stack([(v >> s) & 63 for s in (0, 6, 12, 18)], axis=2)
    return parts.reshape(T, q * 4).astype(np.uint8)


_PACK_HOST = {2: _pack2_host, 4: _pack4_host, 6: _pack6_host}
_UNPACK_HOST = {2: _unpack2_host, 4: _unpack4_host, 6: _unpack6_host}


def _pack_host(grid: np.ndarray, mode: int) -> np.ndarray:
    return _PACK_HOST[mode](grid) if mode else grid


def _unpack_host(grid: np.ndarray, mode: int) -> np.ndarray:
    return _UNPACK_HOST[mode](grid) if mode else grid


def _pack_sent_host(grid: np.ndarray, top: np.ndarray, sent: int, packer):
    """top: the (< sent) grid symbols given codes 0..sent-1, most frequent
    first; code ``sent``: the value is the next one of the sidecar.
    Returns (packed codes, [perm (16 B) | exceptions])."""
    flat = grid.reshape(-1)
    lut = np.full(64, sent, np.uint8)
    lut[top] = np.arange(len(top), dtype=np.uint8)
    nib = lut[flat]
    exc = flat[nib == sent]
    side = np.zeros(16 + _exc_bucket(len(exc)), np.uint8)
    side[:len(top)] = top
    side[16:16 + len(exc)] = exc
    return packer(nib.reshape(grid.shape)), side


def _pack_for_upload(grid: np.ndarray, pmode: int):
    """Encode-side pack: a 4- or 6-bit grid goes as mode 23 (2-bit codes +
    sidecar) or mode 15 (nibbles + sidecar) when that ships fewer bytes,
    counted exactly with the 16-byte perm and the sidecar's bucket
    padding.  Returns (mode, packed grid, sidecar or None)."""
    if pmode in (4, 6) and grid.size:
        cnt = np.bincount(grid.reshape(-1), minlength=64)[:64]
        order = np.argsort(-cnt, kind="stable")
        csum = np.cumsum(cnt[order])
        base_b = grid.size * (3 if pmode == 6 else 2) // 4   # flat bytes
        n23 = int(grid.size - csum[2])
        b23 = grid.size // 4 + 16 + _exc_bucket(n23)
        if pmode == 6:
            n15 = int(grid.size - csum[14])
            b15 = grid.size // 2 + 16 + _exc_bucket(n15)
        else:
            b15 = base_b
        if min(b23, b15) < base_b:
            sent, nb = (3, 2) if b23 <= b15 else (_EXC_SYM, 4)
            top = order[:sent]
            top = top[cnt[top] > 0].astype(np.uint8)
            packed, side = _pack_sent_host(
                grid, top, sent, _pack2_host if nb == 2 else _pack4_host)
            return (23 if nb == 2 else 15), packed, side
    return pmode, _pack_host(grid, pmode), None


def _upload_grid(layout, flat_syms: np.ndarray, model, device, extra_aux):
    """The stream's (T, L) uint8 symbol grid on ``device``: packed on the
    host, copied, unpacked there (K15); unpacked with caller-supplied
    contexts (``extra_aux``), as in the reference."""
    grid = to_grid(layout, np.asarray(flat_syms, np.uint8))
    if extra_aux:
        return torch.from_numpy(grid).to(device)
    mode, packed, side = _pack_for_upload(grid, _pack_mode(model, layout.L))
    packed = torch.from_numpy(packed).to(device)
    if not mode:
        return packed
    if side is not None:
        side = torch.from_numpy(side).to(device)
    return kernels.unpack_grid(packed, mode, side)


def _unsent_host(nib: np.ndarray, side: np.ndarray) -> np.ndarray:
    """K17's (nibbles, [perm | every exception]) -> the (T, L) grid: the
    k-th sentinel in scan order takes exception k (the reference's
    exc[cumsum(mask) - 1], without the (T, L) int64 scan)."""
    codes = _unpack4_host(nib)
    out = side[:16][codes]
    mask = codes == _EXC_SYM
    out[mask] = side[16:16 + int(np.count_nonzero(mask))]
    return out


def _ctx_grid(layout, extra_aux: Optional[Dict[str, np.ndarray]], device):
    """FlatModel's per-symbol contexts as a (T, L) int32 grid (0 at
    padding), or None."""
    if not extra_aux:
        return None
    ctx = np.asarray(extra_aux["ctx"]).astype(np.int32)
    return torch.from_numpy(to_grid(layout, ctx)).to(device)


class EncodeJob:
    """Dispatched encode; :meth:`finalize` syncs and serializes."""

    def __init__(self, T: int, L: int, nsym: int, wpacked, n_words, x_final):
        self._T, self._L, self._nsym = T, L, nsym
        self._wpacked = wpacked
        self._n_words = n_words
        self._x_final = x_final

    def finalize(self) -> bytes:
        n_words = int(self._n_words.item())
        words = self._wpacked[:n_words].cpu().numpy().view(np.uint16)
        xf = self._x_final.cpu().numpy().view(np.uint32)
        return (_HDR.pack(self._T, self._L, n_words, self._nsym)
                + xf.astype("<u4").tobytes() + words.astype("<u2").tobytes())


class DecodeJob:
    """Dispatched decode; :meth:`finalize` syncs and returns read-major
    flat symbols.  ``syms_dev`` is the grid packed in ``pmode`` (K16);
    ``sent`` K17's (nibbles, sidecar, exception count) of a 6-bit grid."""

    def __init__(self, layout, syms_dev, pmode: int = 0, sent=None):
        self._layout = layout
        self._syms = syms_dev
        self._pmode = pmode
        self._sent = sent

    def finalize(self) -> np.ndarray:
        if self._sent is not None:
            nib, side, n_exc = self._sent
            n_exc = int(n_exc.item())
            # the sentinel pack when it is the fewer bytes to copy
            if (n_exc <= side.numel() - 16
                    and nib.numel() + 16 + n_exc < self._syms.numel()):
                grid = _unsent_host(nib.cpu().numpy(),
                                    side[:16 + n_exc].cpu().numpy())
                return from_grid(self._layout, grid)
        grid = _unpack_host(self._syms.cpu().numpy(), self._pmode)
        return from_grid(self._layout, grid)


def encode_stream_job(model, params: CodecParams, flat_syms: np.ndarray,
                      counts_per_read: np.ndarray,
                      counts0: Union[FrozenTable, np.ndarray, None] = None,
                      n_lanes: Optional[int] = None, adapt: bool = False,
                      device="cuda",
                      extra_aux: Optional[Dict[str, np.ndarray]] = None
                      ) -> EncodeJob:
    """Dispatch one stream's encode to ``device``: frozen against
    ``counts0``, or adaptive (``adapt=True``) from a fresh table or from
    ``counts0`` (raw counts); FlatModel takes its per-symbol contexts in
    ``extra_aux["ctx"]``."""
    counts_per_read = np.asarray(counts_per_read, np.int64)
    nsym = int(counts_per_read.sum())
    L = n_lanes or params.n_lanes(nsym)
    layout = make_layout(counts_per_read, L)
    if adapt:
        c0 = _adapt_counts0(counts0, device)
    else:
        table = _as_table(counts0, device)
    syms = _upload_grid(layout, flat_syms, model, device, extra_aux)
    cg = torch.from_numpy(_counts_grid(counts_per_read, L)).to(device)
    if adapt:
        ctxg = _ctx_grid(layout, extra_aux, device)
        chunk = 0 if ctxg is not None else _chunk_of(params, layout.T)
        if chunk:
            sf, _ = kernels.semi_encode_walk(
                syms, cg, model, _n_halve_chunk(model, L, chunk), chunk, c0)
        else:
            sf = kernels.adapt_encode_walk(syms, cg, model,
                                           _n_halve(model, L), ctxg, c0)
        words, emit, x_final = kernels.rans_encode_sf(sf, cg)
    else:
        words, emit, x_final = kernels.frozen_encode_lanes(
            syms, cg, table.packed, model)
    wpacked, n_words = kernels.compact_words(words, emit)
    return EncodeJob(layout.T, L, nsym, wpacked, n_words, x_final)


def encode_stream(model, params: CodecParams, flat_syms: np.ndarray,
                  counts_per_read: np.ndarray, counts0=None,
                  n_lanes: Optional[int] = None, adapt: bool = False,
                  device="cuda", extra_aux=None) -> bytes:
    """Encode one logical stream (read-major flat symbols + per-read
    counts); returns the serialized payload."""
    return encode_stream_job(model, params, flat_syms, counts_per_read,
                             counts0, n_lanes, adapt, device,
                             extra_aux).finalize()


def decode_stream_job(model, params: CodecParams, payload: bytes,
                      counts_per_read: np.ndarray,
                      counts0: Union[FrozenTable, np.ndarray, None] = None,
                      adapt: bool = False, device="cuda",
                      extra_aux: Optional[Dict[str, np.ndarray]] = None,
                      ctx_shard=None) -> DecodeJob:
    """Dispatch one stream's decode (frozen, or adaptive from a fresh
    table or ``counts0``) to ``device``.  ctx_shard: a device list; the
    frozen decode then runs with the table split by rows over those
    devices (``counts0`` one FrozenTable of rows a device,
    pipeline/frozen.device_shard_tables) through K18
    (parallel/mesh.decode_frozen_sharded_stream; the same symbols).  Its
    grid comes back unpacked, as in the reference."""
    T, L, n_words, nsym = _HDR.unpack_from(payload, 0)
    off = _HDR.size
    states = np.frombuffer(payload, "<u4", L, off).copy()
    off += 4 * L
    words = np.frombuffer(payload, "<u2", n_words, off)
    counts_per_read = np.asarray(counts_per_read, np.int64)
    if int(counts_per_read.sum()) != nsym:
        raise ValueError(
            f"corrupt stream: symbol count {nsym} in payload header does "
            f"not match length stream total {int(counts_per_read.sum())}")
    layout = make_layout(counts_per_read, L)
    if layout.T != T:
        raise ValueError(
            f"corrupt stream: layout T={layout.T} vs payload T={T}")
    if ctx_shard is not None:
        if (adapt or extra_aux or len(ctx_shard) < 2
                or model.n_ctx % len(ctx_shard)
                or len(counts0) != len(ctx_shard)):
            raise ValueError("ctx-sharded decode: a frozen stream, 2 or more "
                             "devices dividing the table's rows, one table "
                             "shard a device")
    elif adapt:
        c0 = _adapt_counts0(counts0, device)
    else:
        table = _as_table(counts0, device)
    # K4/K6/K12/K18 read words[min(off + rank, W - 1)] of this zero-padded
    # buffer (power of two, >= 1024 — the reference's bucket), so renorm
    # reads past the real words on a corrupt payload decode zeros
    bucket = 1024
    while bucket < n_words + 8:
        bucket <<= 1
    words_pad = np.zeros(bucket, np.uint16)
    words_pad[:n_words] = words
    if ctx_shard is not None:
        from fastqueeze_tpu_torch.parallel.mesh import (
            ctx_mesh, decode_frozen_sharded_stream)
        syms, _ = decode_frozen_sharded_stream(
            ctx_mesh(ctx_shard), 0, states.view(np.int32),
            words_pad.view(np.int16), _counts_grid(counts_per_read, L), T,
            [t.cum for t in counts0], model)
        return DecodeJob(layout, syms)
    states_dev = torch.from_numpy(states.view(np.int32)).to(device)
    words_dev = torch.from_numpy(words_pad.view(np.int16)).to(device)
    cg = torch.from_numpy(_counts_grid(counts_per_read, L)).to(device)
    if adapt:
        ctxg = _ctx_grid(layout, extra_aux, device)
        chunk = 0 if ctxg is not None else _chunk_of(params, T)
        if chunk:
            syms, _ = kernels.semi_decode(
                states_dev, words_dev, cg, T, model,
                _n_halve_chunk(model, L, chunk), chunk, c0)
        else:
            syms = kernels.adapt_decode(states_dev, words_dev, cg, T, model,
                                        _n_halve(model, L), ctxg, c0)
    else:
        syms = kernels.frozen_decode(states_dev, words_dev, cg, T,
                                     table.cum, model)
    pmode = 0 if extra_aux else _pack_mode(model, L)
    if not pmode:
        return DecodeJob(layout, syms)
    sent = kernels.pack15(syms, cg) if pmode == 6 else None
    return DecodeJob(layout, kernels.pack_grid(syms, pmode), pmode, sent)


def decode_stream(model, params: CodecParams, payload: bytes,
                  counts_per_read: np.ndarray, counts0=None,
                  adapt: bool = False, device="cuda",
                  extra_aux=None) -> np.ndarray:
    """Inverse of :func:`encode_stream` -> read-major flat symbols."""
    return decode_stream_job(model, params, payload, counts_per_read,
                             counts0, adapt, device, extra_aux).finalize()


def train_counts(model, params: CodecParams, flat_syms: np.ndarray,
                 counts_per_read: np.ndarray,
                 extra_aux: Optional[Dict[str, np.ndarray]] = None,
                 n_lanes: Optional[int] = None,
                 device="cuda") -> torch.Tensor:
    """Train a frozen (n_ctx, A) int32 count table on ``device`` (K13):
    the (context, symbol) histogram of one stream (read-major flat
    symbols + per-read counts) times inc, plus init, rows halved to cap;
    usable as ``counts0`` (fastqueeze_tpu/ops/engine.py train_counts)."""
    counts_per_read = np.asarray(counts_per_read, np.int64)
    L = n_lanes or params.n_lanes(int(counts_per_read.sum()))
    layout = make_layout(counts_per_read, L)
    syms = _upload_grid(layout, flat_syms, model, device, extra_aux)
    cg = torch.from_numpy(_counts_grid(counts_per_read, L)).to(device)
    return kernels.train_counts(syms, cg, model,
                                _ctx_grid(layout, extra_aux, device))
