"""Native host execution of the frozen wave-rANS coder, and routing.

The frozen (usemodel) bitstream is a pure function of (symbols, layout,
frozen table): native/frozenwave.cpp reproduces the device coder bit for
bit, so which backend codes a stream is an execution choice that never
reaches the archive.  The port routes frozen streams to the card whenever
the engine's device is CUDA; the native coder stays as the oracle
(``FASTQUEEZE_FROZEN_EXEC=host``) and as the CPU default, as in the
reference.  ``NATIVE_CALLS`` counts the native coder's calls, so a run can
show that nothing on the card's path fell back to the host.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

from fastqueeze_tpu_torch.config import RANS_M, CodecParams
from fastqueeze_tpu_torch.io import native
from fastqueeze_tpu_torch.models.base import QualModel, SeqModel
from fastqueeze_tpu_torch.ops.lanes import make_layout

_HDR = struct.Struct("<IIII")  # T, L, n_words, n_symbols (engine._HDR)

NATIVE_CALLS: Dict[str, int] = {"encode": 0, "decode": 0}


def pack_payload(layout_T: int, L: int, words: np.ndarray,
                 states: np.ndarray, nsym: int) -> bytes:
    """Serialize the engine wire format."""
    return (_HDR.pack(layout_T, L, len(words), nsym)
            + states.astype("<u4").tobytes()
            + words.astype("<u2").tobytes())


def unpack_payload(payload: bytes, counts: np.ndarray):
    """Parse + validate the engine wire header against the length stream;
    returns (states, words, L, layout).  Raises ValueError on the corrupt
    shapes a mangled payload can carry."""
    T, L, n_words, nsym = _HDR.unpack_from(payload, 0)
    off = _HDR.size
    states = np.frombuffer(payload, "<u4", L, off)
    off += 4 * L
    words = np.frombuffer(payload, "<u2", n_words, off)
    if int(counts.sum()) != nsym:
        raise ValueError(
            f"corrupt stream: symbol count {nsym} in payload header does "
            f"not match length stream total {int(counts.sum())}")
    layout = make_layout(counts, L)
    if layout.T != T:
        raise ValueError(
            f"corrupt stream: layout T={layout.T} vs payload T={T}")
    return states, words, L, layout


def _spec_of(model):
    """(kind, spec int64 array) for the native walker, or None."""
    if type(model) is SeqModel or (type(model) is QualModel
                                   and model.k <= 8):
        kind, vals = model.spec()
        return kind, np.array(vals, np.int64)
    return None


def route(p: CodecParams, model, device) -> bool:
    """True = code this frozen stream with the native host coder.
    FASTQUEEZE_FROZEN_EXEC=host|device, then ``p.frozen_exec`` (1 host,
    2 device), decide; auto takes the card whenever ``device`` is CUDA
    and the native coder otherwise."""
    if native.get_lib() is None:
        return False
    if model.cap > RANS_M:
        # rows past the cap could quantize a count to freq 0; the device
        # search variants resolve such degenerate rows their own way
        return False
    if _spec_of(model) is None:
        return False
    mode = os.environ.get("FASTQUEEZE_FROZEN_EXEC", "")
    if mode == "host":
        return True
    if mode == "device":
        return False
    if p.frozen_exec == 1:
        return True
    if p.frozen_exec == 2:
        return False
    return torch.device(device).type != "cuda"


def quantize(counts: np.ndarray) -> np.ndarray:
    """Host-side K1: (n_ctx, A) counts -> (n_ctx, A+1) u16."""
    cum = native.quant_table(np.ascontiguousarray(counts, np.int32))
    if cum is not None:
        return cum
    c = counts.astype(np.int64)
    cs = np.cumsum(c, axis=1)
    C = np.maximum(cs[:, -1:], 1)
    cumz = np.concatenate([np.zeros_like(C), cs], axis=1)
    return ((cumz * RANS_M) // C).astype(np.uint16)


class _HostJob:
    """Same surface as engine.EncodeJob/DecodeJob: .finalize()."""

    def __init__(self, result):
        self._result = result

    def finalize(self):
        return self._result


def encode_job(model, p: CodecParams, flat_syms: np.ndarray,
               counts_per_read: np.ndarray, cum: np.ndarray,
               n_lanes: Optional[int] = None) -> Optional[_HostJob]:
    """Native frozen encode -> job whose finalize() yields the serialized
    payload (bit-identical to engine.encode_stream_job)."""
    kind_spec = _spec_of(model)
    if kind_spec is None:
        return None
    kind, spec = kind_spec
    counts = np.ascontiguousarray(counts_per_read, np.int64)
    nsym = int(counts.sum())
    L = n_lanes or p.n_lanes(nsym)
    layout = make_layout(counts, L)
    NATIVE_CALLS["encode"] += 1
    out = native.frozen_encode(cum, model.alphabet,
                               np.asarray(flat_syms, np.uint8), counts, L,
                               kind, spec)
    if out is None:
        return None
    words, states = out
    return _HostJob(pack_payload(layout.T, L, words, states, nsym))


def decode_job(model, p: CodecParams, payload: bytes,
               counts_per_read: np.ndarray,
               cum: np.ndarray) -> Optional[_HostJob]:
    """Native frozen decode -> job whose finalize() yields read-major flat
    symbols (mirror of engine.decode_stream_job)."""
    kind_spec = _spec_of(model)
    if kind_spec is None:
        return None
    kind, spec = kind_spec
    counts = np.ascontiguousarray(counts_per_read, np.int64)
    states, words, L, layout = unpack_payload(payload, counts)
    nsym = int(counts.sum())
    NATIVE_CALLS["decode"] += 1
    flat = native.frozen_decode(cum, model.alphabet, states, words, counts,
                                L, kind, spec, nsym)
    if flat is None:
        return None
    return _HostJob(flat)
