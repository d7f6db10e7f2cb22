"""Native host execution of the adaptive wave-rANS coder, and routing.

The per-wave adaptive bitstream is a pure function of (symbols, layout,
model parameters): native/adaptwave.cpp reproduces the device coder bit
for bit, so which backend codes a stream is an execution choice that
never reaches the archive.  As for the frozen coder (ops/host_frozen.py),
the port routes adaptive seq/qual streams to the card whenever the
engine's device is CUDA; the native coder stays as the oracle
(``FASTQUEEZE_ADAPT_EXEC=host``) and as the CPU default.  ``NATIVE_CALLS``
counts the native coder's calls, so a run can show that nothing on the
card's path fell back to the host.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from fastqueeze_tpu_torch.config import RANS_M, CodecParams
from fastqueeze_tpu_torch.io import native
from fastqueeze_tpu_torch.ops.host_frozen import (
    _HostJob, _spec_of, pack_payload, unpack_payload)
from fastqueeze_tpu_torch.ops.lanes import make_layout

NATIVE_CALLS: Dict[str, int] = {"encode": 0, "decode": 0}


def route(p: CodecParams, model, device) -> bool:
    """True = code this adaptive stream with the native host coder.
    FASTQUEEZE_ADAPT_EXEC=host|device, then ``p.frozen_exec`` (1 host,
    2 device), decide; auto takes the engine whenever ``device`` is CUDA
    or a mesh is requested (``p.mesh_n``), and the native coder
    otherwise."""
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "fq_adapt_encode"):
        return False
    if model.cap > RANS_M:
        # rows past the cap could quantize a count to freq 0; the device
        # search resolves such degenerate rows its own way
        return False
    if model.init * model.alphabet > model.cap:
        # over-cap initial rows: the device applies its bounded n_halve
        # passes per wave while the native coder rescales to the fixed
        # point in one flush, so the bitstreams would diverge
        return False
    if p.adapt_chunk:
        return False          # semi-adaptive walks stay on the device
    if _spec_of(model) is None:
        return False
    mode = os.environ.get("FASTQUEEZE_ADAPT_EXEC", "")
    if mode == "host":
        return True
    if mode == "device":
        return False
    if p.frozen_exec == 1:    # the coder-backend knob covers both paths
        return True
    if p.frozen_exec == 2:
        return False
    # auto: an explicit mesh request keeps the engine and its kernels
    # (their plain versions on the CPU); else the card when there is one
    return not p.mesh_n and torch.device(device).type != "cuda"


def encode_job(model, p: CodecParams, flat_syms: np.ndarray,
               counts_per_read: np.ndarray,
               n_lanes: Optional[int] = None) -> Optional[_HostJob]:
    """Native adaptive encode -> job whose finalize() yields the serialized
    payload (bit-identical to engine.encode_stream_job(adapt=True))."""
    kind_spec = _spec_of(model)
    if kind_spec is None:
        return None
    kind, spec = kind_spec
    counts = np.ascontiguousarray(counts_per_read, np.int64)
    nsym = int(counts.sum())
    L = n_lanes or p.n_lanes(nsym)
    layout = make_layout(counts, L)
    NATIVE_CALLS["encode"] += 1
    out = native.adapt_encode(model.alphabet, model.n_ctx, model.init,
                              model.inc, model.cap,
                              np.asarray(flat_syms, np.uint8), counts, L,
                              kind, spec)
    if out is None:
        return None
    words, states = out
    return _HostJob(pack_payload(layout.T, L, words, states, nsym))


def decode_job(model, p: CodecParams, payload: bytes,
               counts_per_read: np.ndarray) -> Optional[_HostJob]:
    """Native adaptive decode -> job whose finalize() yields read-major
    flat symbols (mirror of engine.decode_stream_job(adapt=True))."""
    kind_spec = _spec_of(model)
    if kind_spec is None:
        return None
    kind, spec = kind_spec
    counts = np.ascontiguousarray(counts_per_read, np.int64)
    states, words, L, layout = unpack_payload(payload, counts)
    nsym = int(counts.sum())
    NATIVE_CALLS["decode"] += 1
    flat = native.adapt_decode(model.alphabet, model.n_ctx, model.init,
                               model.inc, model.cap, states, words, counts,
                               L, kind, spec, nsym)
    if flat is None:
        return None
    return _HostJob(flat)
