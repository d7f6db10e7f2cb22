"""Lossy quality transform ("R-Block", reference rblock @0x426c10, CLI -l).

rblock_transform is copied from fastqueeze_tpu/pipeline/lossy.py (host
numpy; no kernel); apply_lossy, parse_lossy and lossy_pair are the
compressors' one way in (fastqueeze_tpu/pipeline/driver.py apply_lossy):
every block's qualities before its MD5, and the training prefixes.

The reference's implementation aborts with heap corruption (SURVEY.md §2.1
— "In this binary the path is broken"); this is a correct, vectorized
re-design with the documented semantics: greedily grow runs of quality
values while the spread of the run (max+1)/(min+1) stays under FACTOR, then
replace each maximal run with round(sqrt(min*max)) — the geometric mean —
producing piecewise-constant strings that range-code far better.  Encode-
side only; decode reproduces the transformed qualities exactly.

Vectorized as a wave loop: all reads advance one position per step (numpy,
lanes = reads), so a 50 MB block transforms in ~read-length steps instead
of a per-symbol scalar loop.
"""

from __future__ import annotations

import numpy as np

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.io.fastq import assemble_block, parse_block


def rblock_transform(qflat: np.ndarray, lengths: np.ndarray,
                     factor: float) -> np.ndarray:
    """qflat: per-read concatenated Phred values (0..93, int). Returns the
    transformed values, same shape."""
    if factor <= 1.0 or len(qflat) == 0:
        return qflat
    R = len(lengths)
    maxlen = int(lengths.max()) if R else 0

    # (R, maxlen) padded matrix of q+1 (avoid zero in ratios); boolean-mask
    # assignment enumerates (read, pos) row-major, matching qflat's layout
    q = np.zeros((R, maxlen), np.int32)
    mask = np.arange(maxlen)[None, :] < lengths[:, None]
    q[mask] = qflat.astype(np.int32) + 1

    run_id = np.zeros((R, maxlen), np.int64)   # per-read run index
    run_min = q[:, 0].copy()
    run_max = q[:, 0].copy()
    cur = np.zeros(R, np.int64)
    for t in range(1, maxlen):
        qt = q[:, t]
        nmin = np.minimum(run_min, qt)
        nmax = np.maximum(run_max, qt)
        ok = (nmax.astype(np.float64) <= factor * nmin) & mask[:, t]
        # continue run where ok; else start a new run at t
        cur = np.where(ok, cur, cur + 1)
        run_min = np.where(ok, nmin, qt)
        run_max = np.where(ok, nmax, qt)
        run_id[:, t] = cur

    # per-(read, run) geometric mean via segment min/max
    seg = run_id + np.arange(R, dtype=np.int64)[:, None] * maxlen
    seg_flat = seg[mask]
    q_valid = q[mask]
    n_seg = R * maxlen
    mins = np.full(n_seg, 1 << 30, np.int64)
    maxs = np.zeros(n_seg, np.int64)
    np.minimum.at(mins, seg_flat, q_valid)
    np.maximum.at(maxs, seg_flat, q_valid)
    repl = np.rint(np.sqrt(mins.astype(np.float64)
                           * maxs.astype(np.float64))).astype(np.int32)

    return (repl[seg_flat] - 1).astype(qflat.dtype)  # back to 0-based Phred


def lossy_quals(params: CodecParams, block) -> None:
    """The R-Block transform of ``block``'s qualities (a new array; the
    training prefixes take it without their plaintext)."""
    if params.lossy_factor > 1.0:
        q = block.qual_flat.astype(np.int32) - 33
        q = rblock_transform(q, block.lengths, params.lossy_factor)
        block.qual_flat = (q + 33).astype(np.uint8)


def apply_lossy(params: CodecParams, block):
    """R-Block quality transform (encode side only); returns the new
    plaintext bytes and the block, so the MD5s cover what decode will
    reproduce."""
    lossy_quals(params, block)
    return assemble_block(block), block


def parse_lossy(params: CodecParams, raw: bytes, final_nl: bool):
    """(raw, block): the block parsed, then transformed under -l."""
    block = parse_block(raw, final_nl)
    if params.lossy_factor > 1.0:
        raw, block = apply_lossy(params, block)
    return raw, block


def lossy_pair(p: CodecParams, raw1, b1, raw2, b2):
    """Both mates' blocks (and their plaintext) through -l's transform."""
    if p.lossy_factor > 1.0:
        raw1, b1 = apply_lossy(p, b1)
        raw2, b2 = apply_lossy(p, b2)
    return raw1, b1, raw2, b2
