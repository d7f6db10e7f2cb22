"""Self-referential alignment ("-S"): compress each block against a
reference assembled from its OWN reads.

Copied from fastqueeze_tpu/pipeline/selfref.py.  Every compress runs the
auto probe (auto_self_align), whose answer is written into PARAM; with
-S or a yes, the driver codes each block through maybe_align_self and
the ordinary alignment streams (pipeline/blockcodec.py).  The encoder is
the native host aligner (fq_selfref_align); no device kernel runs here.

No reference equivalent in SeqArc (its aligned mode needs an external
FASTA; SURVEY.md C13).  The construction that makes this decodable with
zero side data: the per-block reference is exactly the concatenation of
the reads that stay in the entropy-coded SEQ stream — the unmapped,
non-duplicate, degenerate-free reads, in block order.  Decode fills those
reads first, rebuilds the byte-identical reference, and reconstructs every
mapped read through the ordinary alignment streams (pos/rev/mismatch —
the SURVEY.md C16 machinery, unchanged).  No permutation stream, no
stored reference, no new decode kernels; a SPRING-class capability for
high-coverage / near-duplicate data at the cost of one aligner pass.

The encoder policy is free to change without touching the format (decode
only consumes the outcome).  Round-4 policy: ONE index over a reference
built from ALL candidate reads, one sequential native pass
(native/alignhost.cpp fq_selfref_align) where read r may map only to a
window inside a single EARLIER still-kept read's span — every constraint
input is decided before it is consulted, and positions are emitted
directly in final-reference coordinates via the kept-prefix running sum.
This replaced the wave loop (align against a growing prefix, geometric
index rebuilds): one index build instead of ~5, no within-wave blindness
(a read can map to ANY earlier kept read), measured ~3x the wave-loop
encode speed at a better ratio.  Exact duplicates are already handled by
the cheaper duplicate tier and are neither aligned nor appended.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.io.fastq import FastqBlock

# --- auto gate (self_align = -1, the default): a per-file probe on the
# first block decides whether -S pays.  Two stages, cheap-first:
#   1. prefilter: projected seq-model bits/base on a hash-sampled read
#      subset (hash-parity holdout NLL against the real order-(slevel+7)
#      table).  Low-diversity data the context model already crushes
#      (e.g. the telomeric fixture: ~0.3 b/b) rejects here for the cost
#      of one histogram — no aligner work at all.
#   2. mini self-align on the same sample; enable only when the projected
#      aligned stream (pos + flags + mismatches for mapped reads, model
#      cost for the rest) undercuts the pure model cost by a margin.
# Decided once per file (before the block loop), so -t N / --mesh N
# payload invariance holds.
_AUTO_SAMPLE_READS = 1536
_AUTO_PROBE_ORDER = 8   # stage-1 context order cap: 4^8 rows keep the
                        # histogram ~1 ms (the real order-10 table costs
                        # ~130 ms of full-table sums); a shorter context
                        # can only OVERestimate model bits — at worst the
                        # probe proceeds to stage 2, which measures
_AUTO_MIN_MODEL_BPB = 0.9
_AUTO_MARGIN = 0.95
_MIS_BITS = 12.0        # per-mismatch stream cost (delta pos + 2-bit char)
_AUTO_MIN_PROBE_MAP = 10  # fewer mapped probe reads => curve fit is noise


def _map_frac_of(x: float) -> float:
    """Block mapped fraction when reads-per-locus density gives x = R/G:
    avg over reads of P(an earlier read covers this one) under a Poisson
    start model = 1 - (1/x)(1 - exp(-x)).  Validated on the synthetic
    20x fixture: G fit at a 1,536-read prefix predicts the 12,000-read
    block's mapped fraction within 0.5 pp (57.8% measured, 58.3%
    predicted)."""
    import math
    if x <= 1e-9:
        return 0.0
    return 1.0 - (1.0 - math.exp(-min(x, 50.0))) / min(x, 50.0)


def _solve_density(m: float, n: int) -> float:
    """Invert _map_frac_of: the G with avg-map-fraction m at n reads."""
    m = min(max(m, 1e-6), _map_frac_of(50.0) - 1e-6)
    lo, hi = 1e-6, 50.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if _map_frac_of(mid) < m:
            lo = mid
        else:
            hi = mid
    return n / ((lo + hi) / 2)


def auto_self_align(p: CodecParams, block: FastqBlock, dbg=None) -> bool:
    import dataclasses
    import math
    import time as _time

    from fastqueeze_tpu_torch.models.base import seq_model_from_params
    from fastqueeze_tpu_torch.pipeline.blockcodec import _BASE_MAP
    from fastqueeze_tpu_torch.pipeline.frozen import (
        _cap_rescale, _hist_nll_bits, _sample_keep, seq_ctx_flat)
    t0 = _time.time()
    R = block.n_reads
    if R < 64:
        return False

    # --- stage 1: seq-model bits/base on a hash-sampled read subset,
    # hash-parity holdout NLL (in-sample NLL rewards big-table overfit) ---
    stride = max(1, R // _AUTO_SAMPLE_READS)
    keep = _sample_keep(R, stride)
    if int(keep.sum()) < 64:
        keep = np.ones(R, bool)
    sym_keep = np.repeat(keep, block.lengths)
    lengths = block.lengths[keep]
    codes = _BASE_MAP[block.seq_flat[sym_keep]]
    codes = np.where(codes == 255, 0, codes)
    model = seq_model_from_params(
        dataclasses.replace(p, slevel=min(p.slevel,
                                          _AUTO_PROBE_ORDER - 7)))
    ctx = seq_ctx_flat(model, codes, lengths)
    ridx = np.arange(int(keep.sum()), dtype=np.uint32)
    odd = (((ridx * np.uint32(2654435761)) >> np.uint32(16)) & 1).astype(bool)
    hold = np.repeat(odd, lengths)
    n = model.n_ctx * model.alphabet
    key = ctx * model.alphabet + codes
    h_train = np.bincount(key[~hold], minlength=n)[:n].reshape(
        model.n_ctx, model.alphabet)
    h_eval = np.bincount(key[hold], minlength=n)[:n].reshape(
        model.n_ctx, model.alphabet)
    counts = _cap_rescale(model, np.asarray(h_train, np.int32))
    eval_syms = int(h_eval.sum())
    if eval_syms == 0:
        return False
    bpb = _hist_nll_bits(counts, h_eval) / eval_syms
    if dbg is not None:
        dbg.add("selfref_probe_s", _time.time() - t0)
        dbg.vals["selfref_probe_bpb"] = round(bpb, 3)
        t0 = _time.time()        # stage 2 adds only its own delta
    if bpb < _AUTO_MIN_MODEL_BPB:
        return False

    # --- stage 2: mini self-align on a CONTIGUOUS read prefix.  Self-ref
    # mapping probability grows with how many reads precede a read, so a
    # subsample maps far less than the block will: fit the density from
    # the prefix's mapped fraction and extrapolate the full-block one ---
    n_pre = min(R, _AUTO_SAMPLE_READS)
    pre_syms = int(block.lengths[:n_pre].sum())
    prefix = FastqBlock(
        n_reads=n_pre, ids=[], plus=[],
        seq_flat=block.seq_flat[:pre_syms],
        qual_flat=block.qual_flat[:pre_syms],
        lengths=block.lengths[:n_pre], raw_len=0, final_newline=True)
    res, rc = maybe_align_self(
        dataclasses.replace(p, min_map_ratio=0.0), prefix, None)
    if dbg is not None:
        dbg.add("selfref_probe_s", _time.time() - t0)
    if res is None:
        return False
    n_map = int(res.mapped.sum())
    if n_map < _AUTO_MIN_PROBE_MAP:
        return False
    g = _solve_density(n_map / n_pre, n_pre)
    m_full = _map_frac_of(R / g)
    if m_full < p.min_map_ratio:
        return False
    # projected stream bits per read at the extrapolated mapped fraction
    L_avg = float(block.lengths.mean())
    mis_per_map = float(res.mis_mask[res.mapped].sum()) / n_map
    ref_syms = max((1.0 - m_full) * R * L_avg, 2.0)
    pos_bits = math.log2(ref_syms) + 2.0             # pos + map/rev flags
    aligned = (m_full * (pos_bits + mis_per_map * _MIS_BITS)
               + (1.0 - m_full) * L_avg * bpb + 1.0)
    model_only = L_avg * bpb
    if dbg is not None:
        dbg.vals["selfref_probe_map"] = round(m_full, 3)
        dbg.vals["selfref_probe_gain"] = round(
            1.0 - aligned / max(model_only, 1e-9), 3)
    return aligned < _AUTO_MARGIN * model_only


def ref_eligible(mapped: np.ndarray, sdup: np.ndarray,
                 dege_cnt: np.ndarray, lengths: np.ndarray,
                 k: int) -> np.ndarray:
    """Reads whose bases form the self-reference.  MUST be computed
    identically on encode and decode (both only need per-read facts that
    the archive carries): unmapped, not a seq-duplicate, degenerate-free,
    and at least one seed long."""
    return ~mapped & ~sdup & (dege_cnt == 0) & (lengths >= k)


def _mk_aligner(p: CodecParams, codes: np.ndarray):
    """Aligner over an in-memory code prefix (no FASTA, no MD5)."""
    from fastqueeze_tpu_torch.align.hash import Aligner
    from fastqueeze_tpu_torch.align.index import build_from_ref
    from fastqueeze_tpu_torch.align.ref import RefSeq
    ref = RefSeq(codes=codes, amb_mask=np.zeros(len(codes), bool),
                 names=["self"], bounds=np.array([0, len(codes)], np.int64),
                 md5="")
    return Aligner(build_from_ref(ref, p), p)


def maybe_align_self(p: CodecParams, block: FastqBlock, dbg=None
                     ) -> Tuple[Optional[object], Optional[np.ndarray]]:
    """(AlignResult, ref_codes) for self-referential coding of `block`,
    or (None, None) when too few reads map to pay for the streams
    (min_map_ratio gate, like the external-reference path).

    One-pass policy (round 4; replaces the wave loop): ONE index over a
    reference built from ALL candidate reads, one native pass
    (fq_selfref_align) in which read r may map only to a window inside a
    single EARLIER still-kept read's span — so every constraint is
    decided by the time it is consulted, and positions are emitted
    directly in final-reference coordinates.  Reads can map to any
    earlier kept read (the wave loop was blind within a wave and paid
    geometric index rebuilds).  Encoder policy only — decode rebuilds
    the identical reference from the mapped flags (ref_eligible)."""
    from fastqueeze_tpu_torch.align.hash import AlignResult, lp_bucket
    from fastqueeze_tpu_torch.pipeline.blockcodec import _BASE_MAP, dup_masks
    t0 = time.time()
    R = block.n_reads
    lengths = block.lengths
    k = p.seed_len
    codes_flat = _BASE_MAP[block.seq_flat]
    dege_flat = codes_flat == 255
    codes_flat = np.where(dege_flat, 0, codes_flat)
    read_off = np.cumsum(lengths) - lengths

    sdup = np.zeros(R, bool)
    if p.dedup and R > 1:
        s_src, _ = dup_masks(block)
        if s_src is not None:
            sdup = s_src >= 0
    dege_cnt = np.zeros(R, np.int64)
    if dege_flat.any():
        rows_d = np.searchsorted(read_off, np.flatnonzero(dege_flat),
                                 side="right") - 1
        dege_cnt = np.bincount(rows_d, minlength=R).astype(np.int64)
    is_cand = ~sdup & (dege_cnt == 0) & (lengths >= k)
    alignable = is_cand & (lengths <= p.align_max_len)
    n_alignable = int(alignable.sum())
    if n_alignable == 0:
        if dbg is not None:
            dbg.add("fqz_blocks", 1)
        return None, None
    lp = lp_bucket(int(lengths[alignable].max()))

    # all-candidates reference (block order; final ref = kept subset)
    sel = np.repeat(read_off[is_cand], lengths[is_cand]) \
        + _intra(lengths[is_cand])
    allref = codes_flat[sel]
    aligner = _mk_aligner(p, allref)
    args = (aligner._h_keys, aligner._h_offsets, aligner._h_positions,
            aligner._h_packed, aligner._h_l1, aligner._l1_shift,
            aligner._search_steps, len(allref), codes_flat, dege_flat,
            read_off, lengths, lp, alignable, is_cand, k, p.seed_stride,
            p.seed_max_occ, p.seed_big_occ, 1 + p.rescue_seeds,
            p.seed_excl_bp, p.max_mis, p.both_strands)
    from fastqueeze_tpu_torch.io import native
    res = native.selfref_align(*args)
    if res is None:
        raise RuntimeError("the self-align probe needs the native library "
                           "(make -C native)")
    mapped, pos32, is_rev, mis_mask = res
    if dbg is not None:
        dbg.add("selfref_s", time.time() - t0)
    n_mapped = int(mapped.sum())
    if n_mapped / n_alignable < p.min_map_ratio:
        if dbg is not None:
            dbg.add("fqz_blocks", 1)
        return None, None
    kept = is_cand & ~mapped
    sel = np.repeat(read_off[kept], lengths[kept]) + _intra(lengths[kept])
    ref_codes = codes_flat[sel]
    if dbg is not None:
        dbg.add("align_blocks", 1)
        dbg.add("mapped_reads", n_mapped)
        dbg.add("selfref_bases", len(ref_codes))
    return AlignResult(mapped, pos32.astype(np.int64), is_rev,
                       mis_mask), ref_codes


def _intra(lens: np.ndarray) -> np.ndarray:
    offs = np.cumsum(lens) - lens
    return (np.arange(int(lens.sum()), dtype=np.int64)
            - np.repeat(offs, lens))
