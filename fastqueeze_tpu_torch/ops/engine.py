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
:func:`train_counts` trains a frozen table on the device (K13).  See
ops/kernels.py.

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
    """Upload a (n_ctx, A) count table and quantize it (K1)."""
    c = torch.from_numpy(np.ascontiguousarray(counts, np.int32)).to(device)
    return FrozenTable(*kernels.quant_pack(c))


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
    flat symbols."""

    def __init__(self, layout, syms_dev):
        self._layout = layout
        self._syms = syms_dev

    def finalize(self) -> np.ndarray:
        return from_grid(self._layout, self._syms.cpu().numpy())


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
    syms = torch.from_numpy(
        to_grid(layout, np.asarray(flat_syms, np.uint8))).to(device)
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
                      extra_aux: Optional[Dict[str, np.ndarray]] = None
                      ) -> DecodeJob:
    """Dispatch one stream's decode (frozen, or adaptive from a fresh
    table or ``counts0``) to ``device``."""
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
    if adapt:
        c0 = _adapt_counts0(counts0, device)
    else:
        table = _as_table(counts0, device)
    # K4/K6/K12 read words[min(off + rank, W - 1)] of this zero-padded buffer
    # (power of two, >= 1024 — the reference's bucket), so renorm reads
    # past the real words on a corrupt payload decode zeros
    bucket = 1024
    while bucket < n_words + 8:
        bucket <<= 1
    words_pad = np.zeros(bucket, np.uint16)
    words_pad[:n_words] = words
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
    return DecodeJob(layout, syms)


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
    syms = torch.from_numpy(
        to_grid(layout, np.asarray(flat_syms, np.uint8))).to(device)
    cg = torch.from_numpy(_counts_grid(counts_per_read, L)).to(device)
    return kernels.train_counts(syms, cg, model,
                                _ctx_grid(layout, extra_aux, device))
