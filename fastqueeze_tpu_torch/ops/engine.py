"""Frozen-table wave-rANS engine (the usemodel coder), in PyTorch + CUDA.

Counterpart of the frozen half of fastqueeze_tpu/ops/engine.py; the wire
format is the same:

    header(T, L, n_words, n_symbols) | L x u32 final states | words u16[]

``L`` lanes (32-bit rANS state, 16-bit renormalization words, 14-bit
frequencies) code symbol waves in lockstep; lane l codes reads l, l+L,
l+2L, ... (ops/lanes.py).  Frequencies come from a frozen count table,
quantized once per table and device (K1).  Encode is K2 (per-lane walk,
gather, reverse rANS) then K3 (compaction of the emitted words into
canonical (wave, lane) order); decode is K4.  See ops/kernels.py.

Each job is split into a dispatch (kernels queued on the current CUDA
stream) and ``finalize()``, which synchronizes and serializes, so a
caller can do host work for other streams in between.  The adaptive
coder is not ported yet (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.ops import kernels
from fastqueeze_tpu_torch.ops.lanes import from_grid, make_layout, to_grid

_HDR = struct.Struct("<IIII")  # T, L, n_words, n_symbols

_ADAPT_MSG = "adaptive device coder: ROADMAP Queue A item 5"


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
                      device="cpu") -> EncodeJob:
    """Dispatch one stream's frozen encode to ``device``."""
    if adapt:
        raise NotImplementedError(_ADAPT_MSG)
    table = _as_table(counts0, device)
    counts_per_read = np.asarray(counts_per_read, np.int64)
    nsym = int(counts_per_read.sum())
    L = n_lanes or params.n_lanes(nsym)
    layout = make_layout(counts_per_read, L)
    syms = torch.from_numpy(
        to_grid(layout, np.asarray(flat_syms, np.uint8))).to(device)
    cg = torch.from_numpy(_counts_grid(counts_per_read, L)).to(device)
    words, emit, x_final = kernels.frozen_encode_lanes(syms, cg,
                                                       table.packed, model)
    wpacked, n_words = kernels.compact_words(words, emit)
    return EncodeJob(layout.T, L, nsym, wpacked, n_words, x_final)


def encode_stream(model, params: CodecParams, flat_syms: np.ndarray,
                  counts_per_read: np.ndarray, counts0=None,
                  n_lanes: Optional[int] = None, adapt: bool = False,
                  device="cpu") -> bytes:
    """Encode one logical stream (read-major flat symbols + per-read
    counts) against a frozen table; returns the serialized payload."""
    return encode_stream_job(model, params, flat_syms, counts_per_read,
                             counts0, n_lanes, adapt, device).finalize()


def decode_stream_job(model, params: CodecParams, payload: bytes,
                      counts_per_read: np.ndarray,
                      counts0: Union[FrozenTable, np.ndarray, None] = None,
                      adapt: bool = False, device="cpu") -> DecodeJob:
    """Dispatch one stream's frozen decode to ``device``."""
    if adapt:
        raise NotImplementedError(_ADAPT_MSG)
    table = _as_table(counts0, device)
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
    # K4 reads words[min(off + rank, W - 1)] of this zero-padded buffer
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
    syms = kernels.frozen_decode(states_dev, words_dev, cg, T, table.cum,
                                 model)
    return DecodeJob(layout, syms)


def decode_stream(model, params: CodecParams, payload: bytes,
                  counts_per_read: np.ndarray, counts0=None,
                  adapt: bool = False, device="cpu") -> np.ndarray:
    """Inverse of :func:`encode_stream` -> read-major flat symbols."""
    return decode_stream_job(model, params, payload, counts_per_read,
                             counts0, adapt, device).finalize()
