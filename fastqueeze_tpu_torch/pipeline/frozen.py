"""Frozen-model ("usemodel") mode.

Capability parity with the reference's preprocess model training
(SURVEY.md §2.1 "Frozen-model mode" + §3.4: doPreProcess trains models on a
~34 MB prefix via encode_*_formodel, snapshots them with SaveModelToMem into
the archive's model section, and every block starts coding from the frozen
snapshot — blocks become independently decodable in parallel with
deterministic model state).

Training is a single host histogram over every (context, symbol) pair of
the prefix (native/trainhist.cpp, numpy fallback); the snapshot is the
counts tables themselves, bz2/zlib-packed into the container's MODEL
section.  Blocks then code against the frozen snapshot on the card
(device_tables: K1 quantizes each table once per device).  Copied from
fastqueeze_tpu/pipeline/frozen.py: every choice here shapes the archive.
"""

from __future__ import annotations

import bz2
import io
import json
import math
import queue
import threading
import zlib
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.encap import iter_tlv, write_tlv
from fastqueeze_tpu_torch.io.fastq import FastqBlock
from fastqueeze_tpu_torch.models.base import QualModel, seq_model_from_params
from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid
from fastqueeze_tpu_torch.utils.metrics import count, current, span, stage
_TAG_META = 1
_TAG_SEQ = 2
_TAG_QUAL = 3


def _qual_alphabet(qmax: int) -> int:
    return ((qmax + 1 + 7) // 8) * 8


def qual_vocab(qual_flat: np.ndarray):
    """(qvals, lut) for dense quality-rank coding: qvals = sorted distinct
    phred values present (uint8), lut = raw-char -> rank table (255 =
    absent).  Modern binned data (4-8 distinct values) then codes with an
    8-symbol alphabet instead of a 40+-wide one — fewer search gathers in
    the wave decode, 5x smaller tables."""
    seen = np.zeros(256, bool)
    seen[qual_flat] = True          # boolean scatter: no int64 widening
    present = np.flatnonzero(seen)
    # chars 33..255 all code as dense ranks (decode_qual_128 parity and
    # beyond: the reference's 128-range variant covers chars 33..160,
    # SURVEY.md §2.1 sym:decode_qual_128); <33 would collide with FASTQ
    # record framing (control chars / newline) and is rejected there too
    if len(present) and present.min() < 33:
        raise ValueError("quality characters below Phred+33 range")
    qvals = (present - 33).astype(np.uint8)
    lut = np.full(256, 255, np.uint8)
    lut[present] = np.arange(len(present), dtype=np.uint8)
    return qvals, lut


def qual_lut(qvals: np.ndarray) -> np.ndarray:
    """Raw-char -> rank table for an existing (possibly extended,
    unsorted) value list."""
    lut = np.full(256, 255, np.uint8)
    lut[np.asarray(qvals, np.int64) + 33] = np.arange(len(qvals),
                                                      dtype=np.uint8)
    return lut


# Measured frozen-vs-adaptive crossover on the bundled data (CPU, exact
# archive sizes): adaptive wins at 9.5 MB (6.53x vs 6.40x), frozen wins
# at 16.6 MB (6.91x vs 6.57x) and 23.7 MB (7.18x vs 6.56x) — the deep
# qctx tables only pay once the projected stream amortizes them.
_GATE_MIN_BYTES = 12 * (1 << 20)


def decide_use_model(p: CodecParams, input_bytes: int) -> bool:
    """Reference gate (doCheckSetEncodeOpt @0x408298): scale + Qlevel <= 2.
    Here: on when the input spans multiple blocks (block independence
    makes per-block adaptation restart from zero) OR is past the
    measured single-block crossover, unless forced either way.  Near the
    tie frozen is preferred — it is also the fast (scan-free encode)
    path."""
    if p.use_model == 1:
        return True
    if p.use_model == -1 or p.qlevel > 2:
        return False
    return input_bytes > min(2 * p.block_size_mb * (1 << 20),
                             _GATE_MIN_BYTES)


def _sample_keep(n_reads: int, stride: int) -> np.ndarray:
    """Pseudo-random 1-in-stride read sample (hash of the read index).
    A plain every-Nth sample aliases with periodic input structure
    (replicated files, PE interleaving, tile ordering) and can exclude
    part of the content from training entirely; hashing decorrelates the
    sample from every period.  Bit-identical to native fq_keep_read."""
    if stride <= 1:
        return np.ones(n_reads, bool)
    r = np.arange(n_reads, dtype=np.uint32)
    return (r * np.uint32(2654435761)) <= np.uint32(0xFFFFFFFF // stride)


def _subsample(block: FastqBlock, target_syms: int) -> FastqBlock:
    """Hash-sampled read subsample: a histogram trainer needs
    representative statistics, not every symbol — caps training cost on
    huge prefixes."""
    total = int(block.lengths.sum())
    if total <= target_syms or block.n_reads < 4:
        return block
    stride = int(np.ceil(total / target_syms))
    keep = _sample_keep(block.n_reads, stride)
    sym_keep = np.repeat(keep, block.lengths)
    return FastqBlock(
        n_reads=int(keep.sum()),
        ids=[], plus=[],
        seq_flat=block.seq_flat[sym_keep],
        qual_flat=block.qual_flat[sym_keep],
        lengths=block.lengths[keep],
        raw_len=0, final_newline=True)


def _pos_in_read(lengths: np.ndarray) -> np.ndarray:
    """Flat (read-major) position-within-read for every symbol."""
    n = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    return (np.arange(n, dtype=np.int64)
            - np.repeat(starts, lengths)).astype(np.int32)


def seq_ctx_flat(model, codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Host mirror of SeqModel.context_grids over flat read-major symbols:
    ctx at position p = ((MAGIC << 2p) | pack(last min(p, order) bases))
    & mask.  Bit-identical to the device walk (cross-checked in tests)."""
    from fastqueeze_tpu_torch.config import SEQ_CTX_START
    pos = _pos_in_read(lengths)
    n = len(codes)
    acc = np.zeros(n, np.uint32)
    c = codes.astype(np.uint32)
    for j in range(1, model.order + 1):
        sl = acc[j:]
        sl |= np.where(pos[j:] >= j, c[:-j], np.uint32(0)) << (2 * (j - 1))
    mask = np.uint32(model.mask)
    magic = np.uint64(SEQ_CTX_START & model.mask)
    shift = (2 * np.minimum(pos, model.order)).astype(np.uint64)
    magic_part = np.where(pos < model.order, magic << shift,
                          np.uint64(0)).astype(np.uint32)
    return ((acc | magic_part) & mask).astype(np.int64)


def qual_ctx_flat(model, q: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Host mirror of QualModel.context_grids over flat symbols."""
    pos = _pos_in_read(lengths)
    q = q.astype(np.int32)
    k = max(model.k, 2)
    qs = []
    for j in range(1, k + 1):
        qj = np.zeros_like(q)
        qj[j:] = np.where(pos[j:] >= j, q[:-j], 0)
        qs.append(qj)
    q1, q2 = qs[0], qs[1]
    d = np.where(pos >= 1, np.maximum(0, q1 - q), 0)
    cs = np.cumsum(d)
    starts = (np.cumsum(lengths) - lengths).astype(np.int64)
    base = np.repeat(cs[starts] if len(q) else cs[:0], lengths)
    csp = np.empty_like(cs)
    if len(cs):
        csp[0] = 0
        csp[1:] = cs[:-1]
    drops = np.where(pos >= 1, model.drop_init + csp - base,
                     model.drop_init)
    if model.k >= 2:
        b = model.ctx_base
        ctx = np.minimum(q1, b - 1).astype(np.int64)
        for qj in qs[1:model.k]:
            ctx = ctx * b + np.minimum(qj, b - 1)
        if model.hash_bits:
            ctx = ((ctx.astype(np.uint32) * np.uint32(2654435761))
                   & np.uint32((1 << model.hash_bits) - 1)).astype(np.int64)
        if model.drop_bits:
            ctx = (ctx << model.drop_bits) | np.minimum(
                drops >> 3, (1 << model.drop_bits) - 1)
        if model.pos_bits:
            ctx = (ctx << model.pos_bits) | np.minimum(
                pos >> 4, (1 << model.pos_bits) - 1)
        return ctx
    ctx = ((np.maximum(q1, q2) << 6) + q1) & 0xFFF
    if model.qlevel >= 2:
        ctx = ctx + np.where(q1 == q2, 0x1000, 0)
        ctx = ctx + ((np.minimum(drops, 56) & ~7) << 10)
    if model.qlevel >= 3:
        ctx = ctx + (np.minimum(pos >> 3, 15) << 16)
    return ctx.astype(np.int64)


def _cap_rescale(model, hist: np.ndarray) -> np.ndarray:
    """inc/init weighting + the deterministic cap rescale — bit-identical to
    fastqueeze_tpu's engine._train_counts (native one-pass when
    available)."""
    from fastqueeze_tpu_torch.io import native
    h32 = np.ascontiguousarray(hist, np.int32)
    out = native.cap_rescale(h32, model.inc, model.init, model.cap)
    if out is not None:
        return out
    counts = hist.astype(np.int64) * model.inc + model.init
    for _ in range(24):
        tot = counts.sum(axis=1, keepdims=True)
        over = tot > model.cap
        if not over.any():
            break
        counts = np.where(over, (counts + 1) >> 1, counts)
    return counts.astype(np.int32)


# Big candidate tables only pay off when the projected stream dwarfs the
# serialized table: rows*alphabet above _BIG_TABLE entries requires at
# least _BIG_TABLE_MIN_SYMS projected symbols.  These constants are the
# reference's: they decide the chosen qctx scheme, which shapes the
# archive bytes.
_BIG_TABLE = 6 << 20            # u16 entries ~ 12 MB upload
_BIG_TABLE_MIN_SYMS = 64 << 20
_LADDER_DRY = 2                 # deep-candidate sweep stops after this
                                # many consecutive non-improvements


def _qctx_candidates(A: int):
    """Candidate rank-chain schemes for a trained alphabet of A ranks:
    (k, drop_bits, pos_bits, hash_bits) tuples.  k is the largest chain
    with A^k rows <= 64k; pos/drops variants multiply rows by 8-64 and
    are admitted up to 2^19 rows; when a longer chain doesn't fit exactly
    it is Knuth-hashed into 2^17 rows (collisions blend contexts but the
    deeper conditioning usually nets out ahead).  The NLL + table-size +
    upload-amortization cost model in _select_qctx arbitrates."""
    if A < 2:
        return []
    for k in (4, 3, 2):
        if A ** k <= (1 << 16):
            break
    else:
        return []
    rows = A ** k
    cands = [(k, 3 if rows << 3 <= (1 << 17) else 0, 0, 0)]
    if rows << 3 <= (1 << 19):
        cands.append((k, 0, 3, 0))              # + pos>>4 (cap 7)
    if rows << 6 <= (1 << 19):
        cands.append((k, 3, 3, 0))              # + drops + pos
    if k < 4 and A ** 4 < (1 << 31):            # deeper chain, hashed
        cands.append((4, 0, 0, 17))
        cands.append((4, 0, 0, 18))
    # very deep hashed chains (k = 5..8, up to 2^20 rows): they only
    # clear the big-table gates on >= 64M-symbol (>= 128M for 2^20-row)
    # projections, where the hash-parity holdout scores them honestly;
    # on redundant or low-diversity quality streams the deeper
    # conditioning wins big (166 MB scale input: 7.93x -> 11.7x) and
    # the cost model simply drops them elsewhere.  The ladder is ordered
    # shallow -> deep so _select_qctx's dry-stop bounds train time.
    if k >= 2:
        cands += [(5, 0, 0, 18), (6, 0, 0, 18), (6, 0, 0, 19),
                  (6, 0, 0, 20), (7, 0, 0, 19), (7, 0, 0, 20),
                  (8, 0, 0, 20), (8, 0, 0, 21)]
    return list(dict.fromkeys(cands))


def _hist_nll_bits(counts: np.ndarray, hist: np.ndarray) -> float:
    """Static (frozen-table) code length in bits of a sample with histogram
    `hist` under cap-rescaled table `counts`.

    Sparse: only hist>0 cells contribute, and a sample of S symbols touches
    at most S distinct (ctx, sym) cells — far fewer than the 2^17-row
    candidate tables have — so gather the nonzero cells instead of
    materializing full-table float64 temporaries (measured 16 s -> <0.5 s
    per candidate on the 1-vCPU host)."""
    r, s = np.nonzero(hist)
    if r.size == 0:
        return 0.0
    tot = counts.sum(axis=1, dtype=np.float64)
    c = counts[r, s].astype(np.float64)
    h = hist[r, s].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        bits = h * (np.log2(tot[r]) - np.log2(c))
    return float(bits.sum())


# bit_length LUT for counts < 2^13 (cap <= 8192), built at import: the
# packing thread and the calling thread both bucket tables.  float64 log2
# is exact at/near these magnitudes
_BL_LUT = np.zeros(1 << 13, np.uint8)
_BL_LUT[1:] = np.floor(np.log2(np.arange(1, 1 << 13))).astype(np.uint8) + 1


def _mant_bucket(c: np.ndarray, mbits: int) -> np.ndarray:
    """Round each count DOWN to ``mbits`` significant bits (deterministic;
    floor preserves >= 1 for positive counts).  Table caps bound counts
    below 2^13, so bit_length is one u8 LUT gather — the generic shift
    loop cost 9 s per 2^21-row table in int64."""
    hi = int(c.max()) if c.size else 0
    if hi < (1 << 13):
        u = np.ascontiguousarray(c, np.uint16)
        sh = _BL_LUT[u].astype(np.uint16)     # bit_length per count
        sh = np.where(sh > mbits, sh - mbits, 0).astype(np.uint16)
        return np.maximum((u >> sh) << sh, 1)
    c64 = c.astype(np.int64)
    bl = np.zeros_like(c64)
    x = c64.copy()
    for shift in (16, 8, 4, 2, 1):
        m = x >= (1 << shift)
        bl[m] += shift
        x[m] >>= shift
    sh = np.maximum(bl + 1 - mbits, 0)
    return np.maximum((c64 >> sh) << sh, 1)


def _priced(ship, rows=None):
    """(bz2-9 blob size, the estimate pack it came from): a table past
    _BIG_TABLE entries is priced as 8 x its every 8th row's blob (pack
    None), the pricing of every table _select_qctx scores and ships.
    ``rows(step)`` gives the host the table's every step-th row where
    ``ship`` is not on the host (the card scorer's tables: only those rows
    are copied).  The pack is the table's own bz2-9 blob, which
    _pack_counts reuses when the table ships."""
    step = 8 if math.prod(ship.shape) > _BIG_TABLE else 1
    pack = _pack_counts(ship[::step] if rows is None else rows(step),
                        estimate=True)
    if step > 1:
        return step * len(pack["blob"]), None
    return len(pack["blob"]), pack


def _bucket_ship(counts: np.ndarray, weights, scale: float):
    """Mantissa-bucket the winning table when the blob saving beats the
    projected stream penalty (encoder-only: the bucketed table is what
    ships, both coders walk it, so there is no format change).  Fewer
    distinct count values compress 5-15% better under bz2 at a bounded
    relative-frequency error (<= 2^-mbits).  ``weights.nll(mbits)``: the
    code length of the table bucketed to mbits (0: as it is) over the
    sample (:class:`_HostEval`, :class:`_CardEval`).  Returns (table, its
    priced pack or None: :func:`_priced`)."""
    blob_len, best_pack = _priced(counts)
    best_c = counts
    best_cost = weights.nll(0) / 8.0 * scale + blob_len
    for m in (3, 2):
        b = _mant_bucket(counts, m).astype(counts.dtype)
        blob_len, pack = _priced(b)
        cost = weights.nll(m) / 8.0 * scale + blob_len
        if cost < best_cost:
            best_cost, best_c, best_pack = cost, b, pack
    return best_c, best_pack


def _scores_on_card(device) -> bool:
    """Whether the trainer scores its tables on the card: on a CUDA
    device, as every kernel wrapper chooses (ops/kernels.py _on_card);
    on the CPU, or with no device, the host scores them."""
    if device is None:
        return False
    import torch
    return torch.device(device).type == "cuda"


def _odd_reads(n_reads: int) -> np.ndarray:
    """The holdout half of _select_qctx: a hash parity of each sampled
    read's index.  Plain index parity aliases with PE interleaving
    (mate1/mate2 alternate) and any other period-2 structure; native
    fq_qctx_hist3 splits by the same hash."""
    ridx = np.arange(n_reads, dtype=np.uint32)
    return (((ridx * np.uint32(2654435761)) >> np.uint32(16)) & 1).astype(
        bool)


def _narrow_width(cap: int) -> int:
    """Bytes a count of a table capped at ``cap`` ships in (_narrow_np)."""
    return 1 if cap < (1 << 8) else (2 if cap < (1 << 16) else 4)


def _host_table(t) -> np.ndarray:
    """A card table (kernels.narrow_rows) on the host, u16 as uint16."""
    a = t.cpu().numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


def _log2_table(n: int, device):
    """float64 log2(v) for v < n (at least 1024) on ``device``, filled by
    np.log2, so the card reads numpy's values."""
    import torch
    with np.errstate(divide="ignore"):
        v = np.log2(np.arange(max(n, 1024), dtype=np.float64))
    return torch.from_numpy(v).to(device)


def _card_nll(table, hist, n_terms: int, mbits: int = 0,
              tab_hint: int = 0) -> float:
    """_hist_nll_bits of ``table`` (mantissa-bucketed where mbits > 0)
    over ``hist``, both on one device (K20): the terms there, their sum
    here by np.sum, so the float is numpy's bit for bit.  ``n_terms``
    bounds the nonzero cells of ``hist`` (its symbols or cells)."""
    from fastqueeze_tpu_torch.ops import kernels
    tab = _log2_table(tab_hint, hist.device)
    while True:
        terms, stat = kernels.hist_nll(table, hist, tab, mbits, n_terms)
        n, top = stat.tolist()
        if top < tab.shape[0]:
            break
        tab = _log2_table(top + 1, hist.device)
    if n > n_terms:
        raise RuntimeError(f"hist_nll: {n} terms, room for {n_terms}")
    return float(np.sum(terms[:n].cpu().numpy()))


class _HostEval:
    """The weights of a table's bucket choice (:func:`_bucket_ship`) on
    the host: :meth:`nll` is the code length of the table, bucketed to
    mbits, over the histogram (_hist_nll_bits), on the thread that asks."""

    def __init__(self, table: np.ndarray, hist: np.ndarray):
        self.table, self.hist, self.shape = table, hist, np.shape(hist)

    def score(self) -> None:
        """Nothing to launch."""

    def nll(self, mbits: int) -> float:
        t = self.table
        if mbits:
            t = _mant_bucket(t, mbits).astype(t.dtype)
        return _hist_nll_bits(t, self.hist)


class _CardEval:
    """The weights of a table's bucket choice (:func:`_bucket_ship`) on
    the card: :meth:`score`, on the thread that launches the trainer's
    kernels, gives the code lengths of the table and of its 3- and 2-bit
    mantissa buckets over the histogram (K20); :meth:`nll` reads them on
    any thread (the packing thread waits for them)."""

    def __init__(self, table, hist, n_terms: int, tab_hint: int = 0):
        self.shape = tuple(hist.shape)
        self._args = (table, hist, n_terms, tab_hint)
        self._nlls = Future()

    def score(self) -> None:
        table, hist, n_terms, hint = self._args
        self._args = None
        try:
            self._nlls.set_result({m: _card_nll(table, hist, n_terms, m, hint)
                                   for m in (0, 3, 2)})
        except BaseException as e:
            self._nlls.set_exception(e)
            raise

    def nll(self, mbits: int) -> float:
        return self._nlls.result()[mbits]


def _seq_weights(counts: np.ndarray, hist: np.ndarray, device):
    """The seq table's bucket weights: a :class:`_HostEval`, or on a CUDA
    ``device`` a :class:`_CardEval` of the table and histogram copied to
    the card (its :meth:`_CardEval.score` is the caller's)."""
    if not _scores_on_card(device):
        return _HostEval(counts, hist)
    import torch
    from fastqueeze_tpu_torch.ops.engine import resolve_device
    dev = resolve_device(device)
    t = np.ascontiguousarray(counts)
    t = torch.from_numpy(t.view(np.int16) if t.dtype == np.uint16 else t)
    return _CardEval(t.to(dev), torch.from_numpy(
        np.ascontiguousarray(hist, np.int32)).to(dev),
        min(hist.size, int(np.count_nonzero(hist))))


class _HostScorer:
    """_select_qctx's scoring on the host: each scheme's histograms by the
    native pass (NumPy's where the library is missing), the table by
    _cap_rescale and _narrow_np, its cost by _hist_nll_bits."""

    def __init__(self, qhist, qsyms_fn, lengths, holdout: bool,
                 scale: float, proj_syms: float, native_args):
        self.qhist, self.qsyms_fn, self.lengths = qhist, qsyms_fn, lengths
        self.holdout, self.scale, self.proj = holdout, scale, proj_syms
        self.native_args = native_args
        self._qs = self._mB = None

    def sampled(self):
        if self._qs is None:
            self._qs = self.qsyms_fn().astype(np.int32)
            self._mB = np.repeat(_odd_reads(len(self.lengths)),
                                 self.lengths)
        return self._qs, self._mB

    def _native_pair(self, model):
        """One native pass -> (full_hist, odd_half_hist), or None."""
        from fastqueeze_tpu_torch.io import native
        if self.native_args is None:
            return None
        qraw, lens_full, stride, lut = self.native_args
        return native.qctx_hist(
            qraw, lens_full, stride, lut, model.alphabet, model.k,
            model.ctx_base or 1, model.drop_bits, model.pos_bits,
            model.drop_init, hash_bits=model.hash_bits,
            qlevel=model.qlevel, n_ctx=model.n_ctx, holdout=True)

    def _hists(self, model, full_hist, hB=None):
        """(train_hist, eval_hist, eval_scale, whole-sample hist):
        full/full in-sample, A/B on holdout."""
        if not self.holdout:
            return full_hist, full_hist, self.scale, full_hist
        if hB is None:
            qs, mB = self.sampled()
            ctx = qual_ctx_flat(model, qs, self.lengths)
            n = model.n_ctx * model.alphabet
            key = ctx * model.alphabet + qs
            hB = np.bincount(key[mB], minlength=n)[:n].reshape(
                model.n_ctx, model.alphabet)
        # the host mirror and the native trainer walk identical
        # contexts (cross-checked in tests); clip is belt-and-braces.
        # In-place max: the deep-chain hists are 300+ MB arrays
        hA = np.subtract(full_hist, hB)
        np.maximum(hA, 0, out=hA)
        nB = int(hB.sum())
        return hA, hB, self.proj / max(nB, 1), full_hist

    def probe(self, model):
        pair = self._native_pair(model) if self.holdout else None
        return self._hists(model, np.asarray(self.qhist),
                           pair[1] if pair is not None else None)

    def scheme(self, model):
        from fastqueeze_tpu_torch.io import native
        chist = chist_b = None
        if self.native_args is not None:
            if self.holdout:
                pair = self._native_pair(model)
                if pair is not None:
                    chist, chist_b = pair
            else:
                qraw, lens_full, stride, lut = self.native_args
                chist = native.qctx_hist(
                    qraw, lens_full, stride, lut, model.alphabet, model.k,
                    model.ctx_base, model.drop_bits, model.pos_bits,
                    model.drop_init, hash_bits=model.hash_bits)
        if chist is None:
            qs, _ = self.sampled()
            ctx = qual_ctx_flat(model, qs, self.lengths)
            n = model.n_ctx * model.alphabet
            chist = np.bincount(
                ctx * model.alphabet + qs.astype(np.int64),
                minlength=n)[:n].reshape(model.n_ctx, model.alphabet)
        return self._hists(model, chist, chist_b)

    def score(self, model, hists):
        """(cost, the shipped table): the projected stream bits of the
        table trained on the train half, over the eval half, in bytes,
        plus the bz2-9 size of the table trained on the whole sample."""
        train_hist, eval_hist, eval_scale, ship_hist = hists
        count("qctx_host_scores")
        counts = _narrow_np(
            _cap_rescale(model, np.array(train_hist, np.int32)),
            model.cap)
        ship = counts if ship_hist is train_hist else _narrow_np(
            _cap_rescale(model, np.array(ship_hist, np.int32)), model.cap)
        with span("train.qctx.price"):
            blob_len = _priced(ship)[0]
        return (_hist_nll_bits(counts, eval_hist) / 8.0 * eval_scale
                + blob_len, ship)

    def result(self, ship, hists, scale: float):
        return ship, _HostEval(ship, hists[3]), scale


class _CardHists:
    """A scheme's histograms on the card: the table is trained on
    ``train``, scored over ``eval`` (its symbols projected by
    ``eval_scale``), shipped from the sum of ``ship``; ``whole``: the
    whole sample's histogram where it is on the card already."""

    def __init__(self, model, train, eval_, eval_scale, ship, whole):
        self.model, self.train, self.eval = model, train, eval_
        self.eval_scale, self.ship, self.whole = eval_scale, ship, whole


class _CardScorer:
    """_select_qctx's scoring on the card (a CUDA device): the sampled
    prefix's quality ranks uploaded once as K13 lane grids, the holdout's
    even and odd reads in two; each scheme's histograms by K13's
    histogram half at inc 1 (``train_hist``), each alpha's tables by its
    row half weighing them by inc (``train_rows_sum``) and
    ``narrow_rows``, each cost by K20 (``hist_nll``).  Only the table
    bz2-9 prices (every 8th row past _BIG_TABLE) comes to the host; the
    costs are the host scorer's floats, bit for bit."""

    def __init__(self, p: CodecParams, qmodel, qhist, qsyms_fn, lengths,
                 holdout: bool, scale: float, proj_syms: float, device):
        from fastqueeze_tpu_torch.ops.engine import resolve_device
        self.dev = resolve_device(device)
        self.qhist, self.holdout, self.scale = qhist, holdout, scale
        self.sample = int(np.asarray(qhist).sum())
        self._qhist_dev = None
        qs = np.asarray(qsyms_fn(), np.uint8)
        lens = np.asarray(lengths, np.int64)
        if holdout:
            odd = _odd_reads(len(lens))
            mB = np.repeat(odd, lens)
            self.grids = [self._grid(p, qs[~mB], lens[~odd]),
                          self._grid(p, qs[mB], lens[odd])]
            self.n_eval = int(lens[odd].sum())
            self.eval_scale = proj_syms / max(self.n_eval, 1)
        else:
            self.grids = [self._grid(p, qs, lens)]
            self.n_eval = self.sample
            self.eval_scale = scale

    def _grid(self, p: CodecParams, flat, lens):
        """(symbols, read lengths) of a K13 grid on the card.  The symbols
        go as bytes: packing them for the copy (engine._upload_grid)
        takes the host ~70 ms a grid of 11 M symbols, the copy of the
        bytes a few."""
        import torch
        from fastqueeze_tpu_torch.ops import engine
        L = p.n_lanes(int(lens.sum()))
        grid = to_grid(make_layout(lens, L), flat)
        return (torch.from_numpy(grid).to(self.dev),
                torch.from_numpy(engine._counts_grid(lens, L)).to(self.dev))

    def _hist(self, model, grids):
        """The raw (inc 1) histogram of the model's contexts over grids."""
        import dataclasses
        import torch
        from fastqueeze_tpu_torch.ops import kernels
        one = dataclasses.replace(model, inc=1)
        h = torch.zeros((model.n_ctx, model.alphabet), dtype=torch.int32,
                        device=self.dev)
        for syms, cg in grids:
            kernels.train_hist(syms, cg, one, h)
        return h

    def _qhist(self):
        if self._qhist_dev is None:
            import torch
            self._qhist_dev = torch.from_numpy(
                np.ascontiguousarray(self.qhist, np.int32)).to(self.dev)
        return self._qhist_dev

    def probe(self, model):
        q = self._qhist()
        if not self.holdout:
            return _CardHists(model, q, q, self.eval_scale, [q], q)
        return _CardHists(model, self._hist(model, self.grids[:1]),
                          self._hist(model, self.grids[1:]),
                          self.eval_scale, [q], q)

    def scheme(self, model):
        if not self.holdout:
            h = self._hist(model, self.grids)
            return _CardHists(model, h, h, self.eval_scale, [h], h)
        hA = self._hist(model, self.grids[:1])
        hB = self._hist(model, self.grids[1:])
        return _CardHists(model, hA, hB, self.eval_scale, [hA, hB], None)

    def score(self, model, hists):
        from fastqueeze_tpu_torch.ops import kernels
        count("qctx_card_scores")
        width = _narrow_width(model.cap)
        t = kernels.train_rows_sum([hists.train], model, model.inc)
        counts = kernels.narrow_rows(t, width)
        if len(hists.ship) == 1 and hists.ship[0] is hists.train:
            s, ship = t, counts
        else:
            s = kernels.train_rows_sum(hists.ship, model, model.inc)
            ship = kernels.narrow_rows(s, width)

        def rows(step):
            return _host_table(ship if step == 1
                               else kernels.narrow_rows(s, width, step))

        with span("train.qctx.price"):
            blob_len = _priced(ship, rows)[0]
        nll = _card_nll(counts, hists.eval,
                        min(hists.eval.numel(), self.n_eval), 0,
                        model.cap + model.alphabet + 1)
        return nll / 8.0 * hists.eval_scale + blob_len, ship

    def result(self, ship, hists, scale: float):
        """(the winner's table on the host, its bucket weights: a
        :class:`_CardEval` over the whole sample's histogram, scale)."""
        whole = hists.whole
        if whole is None:
            whole = self._hist(hists.model, self.grids)
        m = hists.model
        return (_host_table(ship),
                _CardEval(ship, whole, min(whole.numel(), self.sample),
                          m.cap + m.alphabet + 1), scale)


def _select_qctx(p: CodecParams, qmodel, qhist, qsyms_fn, lengths,
                 est_total_syms: int, A_train: int,
                 native_args=None, device=None):
    """Train-time quality-context selection (no reference equivalent).

    Compares the fqzcomp-formula table (already trained, `qhist`) against a
    rank-chain candidate on the same sample: projected stream bits (static
    NLL scaled to the estimated total symbol count) + serialized table
    size.  Winner's scheme is written into CodecParams (serialized in
    PARAM, like qmax) and its table returned as (counts, weights, scale)
    for :func:`_ship_qual` (weights None: the table ships as it is; else
    the scorer's :class:`_HostEval` or :class:`_CardEval`).  `qsyms_fn` lazily yields
    the sampled rank symbols (the fused native trainer never materializes
    them; only pay when a candidate exists).  On a CUDA ``device`` the
    card scores the tables (:class:`_CardScorer`), else the host
    (:class:`_HostScorer`); both give the same floats, so the same
    choice."""
    forced = p.qctx_k >= 2
    if forced:
        cands = [(p.qctx_k, p.qctx_drop_bits, p.qctx_pos_bits,
                  p.qctx_hash_bits)]
        alphas = [(p.qctx_init, p.qctx_inc)]
        base = p.qctx_base or A_train
    elif p.qctx_auto:
        cands = _qctx_candidates(A_train)
        # pseudo-count (init) / count-weight (inc) variants: smaller
        # init/inc ratios sharpen well-populated rows (measured ~5%
        # stream win on real data); (0, 0) = inherit qual_init/qual_inc
        alphas = [(0, 0), (1, 16), (1, 24)]
        base = A_train
    else:
        cands = []
    if not cands:
        # _cap_rescale mutates int32 hists in place (native fast path):
        # rescale a copy
        return _narrow_np(_cap_rescale(qmodel, np.array(qhist, np.int32)),
                          qmodel.cap), None, 1.0
    sample = int(qhist.sum())
    scale = max(est_total_syms, sample) / max(sample, 1)
    proj_syms = sample * scale
    # When the table will code more data than it was trained on (prefix
    # training and/or stride sampling), in-sample NLL rewards overfit
    # (sharp pseudo-counts, many rows — the deep hashed chains memorize
    # via collisions) — score on a held-out half instead: table from
    # even-parity sampled reads, NLL weighted by the odd half, both
    # projected to the full input.  In-sample is exact only when the
    # table was trained on essentially the whole input (scale ~1).
    holdout = proj_syms > 1.1 * sample
    if _scores_on_card(device):
        scorer = _CardScorer(p, qmodel, qhist, qsyms_fn, lengths, holdout,
                             scale, proj_syms, device)
    else:
        scorer = _HostScorer(qhist, qsyms_fn, lengths, holdout, scale,
                             proj_syms, native_args)

    best = None
    if not forced:
        bprobe = QualModel(alphabet=qmodel.alphabet, qlevel=p.qlevel,
                           drop_init=p.q_drop_init)
        hists = scorer.probe(bprobe)
        for a in alphas:
            bm = QualModel(alphabet=qmodel.alphabet,
                           init=a[0] or p.qual_init,
                           inc=a[1] or p.qual_inc, cap=qmodel.cap,
                           qlevel=p.qlevel, drop_init=p.q_drop_init)
            cost, table = scorer.score(bm, hists)
            if best is None or cost < best[0]:
                best = (cost, None, a, table, hists)
    # Candidate ladder: the list is ordered shallow -> deep (and narrow ->
    # wide hash for equal depth).  Deep candidates (the k >= 5 hashed
    # chains) are scored with ONLY the best alpha found so far (their
    # table-vs-stream tradeoff is dominated by the conditioning depth,
    # not the pseudo-counts), and after `_LADDER_DRY` consecutive deep
    # candidates fail to improve the running best, the rest are skipped —
    # each deep score costs a full pass + cap-rescale + bz2 over a
    # multi-hundred-MB table pair, so an unbounded sweep would dominate
    # train time.
    dry = 0
    for (k, db, pb, hb) in cands:
        deep = k >= 5
        if deep and dry >= _LADDER_DRY:
            continue
        probe = QualModel(alphabet=qmodel.alphabet, qlevel=p.qlevel,
                          drop_init=p.q_drop_init, k=k, ctx_base=base,
                          drop_bits=db, pos_bits=pb, hash_bits=hb)
        entries = probe.n_ctx * probe.alphabet
        # admission: a dense table bigger than _BIG_TABLE entries can
        # only pay for itself when the projected stream is of the same
        # order as the table (its serialized size grows with entries
        # while the achievable stream saving is bounded by ~1 bit/sym);
        # below that, skip the multi-hundred-MB scoring pass outright.
        # The exact cost model (NLL + blob bytes) arbitrates the rest.
        if (not forced and entries > _BIG_TABLE
                and proj_syms < entries // 2):
            continue
        hists = scorer.scheme(probe)
        cand_alphas = alphas
        if deep and best is not None:
            cand_alphas = [best[2]]
        improved = False
        for a in cand_alphas:
            cand = QualModel(alphabet=qmodel.alphabet,
                             init=a[0] or p.qual_init,
                             inc=a[1] or p.qual_inc, cap=p.qual_cap,
                             qlevel=p.qlevel, drop_init=p.q_drop_init,
                             k=k, ctx_base=base, drop_bits=db,
                             pos_bits=pb, hash_bits=hb)
            cost, table = scorer.score(cand, hists)
            if best is None or cost < best[0]:
                best = (cost, (k, db, pb, hb), a, table, hists)
                improved = True
        if deep:
            dry = 0 if improved else dry + 1
    _, scheme, alpha, table, hists = best
    if scheme is not None:
        p.qctx_k, p.qctx_base = scheme[0], base
        p.qctx_drop_bits, p.qctx_pos_bits = scheme[1], scheme[2]
        p.qctx_hash_bits = scheme[3]
    if not forced:
        p.qctx_init, p.qctx_inc = alpha
    return scorer.result(table, hists, scale)


def _ship_qual(counts: np.ndarray, weights, scale: float):
    """The quality table _select_qctx chose, mantissa-bucketed where that
    pays, and its priced pack (_bucket_ship; None where it was not
    priced).  The weights are scored here, on the calling thread."""
    if weights is not None and tuple(weights.shape) == counts.shape:
        weights.score()
        return _bucket_ship(counts, weights, scale)
    return counts, None


class _Packing:
    """The frozen tables' ship-and-pack on one packing thread, each
    table's from the moment it is final: the seq table's bucket choice
    and pack run while the calling thread selects the quality contexts,
    the quality table's pack after that, and both may finish while the
    blocks are encoded (:func:`serialize_frozen` joins).  The calls and
    their tables are those of packing on the calling thread, so are the
    bytes.  Jobs run in the order they are queued, each as the stage
    ``pack.<table>`` inside ``pack`` of the DebugInfo whose span was open
    where the packing began (spans on this thread add to no call's
    ``spanned_s``).  Leaving the ``with`` block queues no more jobs, and
    the thread ends after those queued; where the block raised, it is
    joined there."""

    def __init__(self):
        self._dbg = current()
        self._jobs = queue.SimpleQueue()
        self._packs: Dict[str, Dict] = {}
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="fq-pack",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        for name, job in iter(self._jobs.get, None):
            if self._error is not None:
                continue
            try:
                with stage(self._dbg, "pack"), \
                        stage(self._dbg, "pack." + name):
                    self._packs[name] = job()
            except BaseException as e:
                self._error = e

    def ship_seq(self, counts: np.ndarray, weights,
                 scale: float) -> Future:
        """Queue the seq table's bucket choice (:func:`_bucket_ship`, by
        ``weights``) and pack, as the first job; the Future holds the
        shipped table as soon as it is chosen."""
        table = Future()

        def job():
            try:
                ship, priced = _bucket_ship(counts, weights, scale)
            except BaseException as e:
                table.set_exception(e)
                raise
            table.set_result(ship)
            return _pack_counts(ship, priced=priced)

        self._jobs.put(("seq", job))
        return table

    def pack_qual(self, counts: np.ndarray, priced: Optional[Dict]) -> None:
        self._jobs.put(("qual", lambda: _pack_counts(counts, priced=priced)))

    def __enter__(self) -> "_Packing":
        return self

    def __exit__(self, exc_type, *_) -> bool:
        self._jobs.put(None)
        if exc_type is not None:
            self._thread.join()
        return False

    def wait(self) -> None:
        self._thread.join()

    def result(self):
        """(seq pack, qual pack) once the thread has ended; its error is
        raised here."""
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self._packs["seq"], self._packs["qual"]


def _ship_seq(packing: _Packing, counts: np.ndarray, hist: np.ndarray,
              scale: float, device) -> Future:
    """Queue the seq table's bucket choice and pack on the packing
    thread; on a CUDA ``device`` the code lengths it weighs are the card's,
    launched here while the thread prices the tables."""
    weights = _seq_weights(counts, hist, device)
    table = packing.ship_seq(counts, weights, scale)
    weights.score()
    return table


def _shipped(packing: _Packing, seq_table: Future, qual, qmax: int,
             qvals: np.ndarray) -> Dict:
    """The frozen dict, once the quality table _select_qctx chose is
    shipped (its pack queued behind the seq table's) and the seq table's
    bucket is chosen; the packs may still run."""
    qual_counts, priced = _ship_qual(*qual)
    packing.pack_qual(qual_counts, priced)
    return {"qmax": qmax, "qvals": qvals, "seq_counts": seq_table.result(),
            "qual_counts": qual_counts, "_pack": packing}


# Content-keyed training memo: training is a pure function of (prefix
# block bytes, params, projection), so re-compressing the same input
# (benchmark loops, retries, identical shards) skips the histogram +
# candidate-selection work entirely.  Entries also carry the chosen
# qctx_* params so a cache hit replays the same CodecParams mutation.
_TRAIN_CACHE: "dict" = {}
_TRAIN_CACHE_MAX = 4
_QCTX_FIELDS = ("qctx_k", "qctx_base", "qctx_drop_bits", "qctx_pos_bits",
                "qctx_hash_bits", "qctx_init", "qctx_inc")
# Fields that never shape training output (pure execution policy) — a
# bench/stage run that differs only in thread count must not retrain.
_EXEC_FIELDS = ("threads", "mesh_n", "shm_index", "frozen_exec",
                "host_stream_max", "multi")


def _train_key_params(p: CodecParams) -> bytes:
    import dataclasses as _dc
    import json as _json
    d = _dc.asdict(p)
    for f in _EXEC_FIELDS:
        d.pop(f, None)
    return _json.dumps(d, sort_keys=True).encode()


def train_frozen(p: CodecParams, block: FastqBlock,
                 target_syms: int = 16 << 20,
                 est_total_syms: int = 0, device=None) -> Dict:
    """Train seq + qual frozen tables from a prefix block (host bincount).
    Memoized on (block content, params, projection); a CUDA ``device``
    scores the candidate tables on the card (_select_qctx), which gives
    the same tables, so the device is not in the memo's key."""
    import hashlib
    h = hashlib.md5()
    h.update(block.seq_flat.tobytes())
    h.update(block.qual_flat.tobytes())
    h.update(np.ascontiguousarray(block.lengths, np.int64).tobytes())
    key = (h.hexdigest(), _train_key_params(p), target_syms, est_total_syms)
    hit = _TRAIN_CACHE.pop(key, None)
    count("train_cache_hit" if hit is not None else "train_cache_miss")
    if hit is not None:
        _TRAIN_CACHE[key] = hit                 # LRU touch
        frozen, chosen = hit
        for f, v in chosen:
            setattr(p, f, v)
        return frozen
    frozen = _train_frozen_impl(p, block, target_syms, est_total_syms,
                                device)
    chosen = [(f, getattr(p, f)) for f in _QCTX_FIELDS]
    _TRAIN_CACHE[key] = (frozen, chosen)
    # _select_qctx wrote the chosen qctx_* scheme into p, so the NEXT
    # compress with this (now-mutated) p computes a different key; the
    # forced retrain would reproduce exactly these tables (same data,
    # scheme pinned to the winner) — register the entry under the
    # post-mutation key too so it hits instead.
    key2 = (key[0], _train_key_params(p), target_syms, est_total_syms)
    if key2 != key:
        _TRAIN_CACHE[key2] = (frozen, chosen)
    while len(_TRAIN_CACHE) > _TRAIN_CACHE_MAX:
        _TRAIN_CACHE.pop(next(iter(_TRAIN_CACHE)))
    return frozen


def _train_frozen_impl(p: CodecParams, block: FastqBlock,
                       target_syms: int = 16 << 20,
                       est_total_syms: int = 0, device=None) -> Dict:
    from fastqueeze_tpu_torch.config import SEQ_CTX_START
    from fastqueeze_tpu_torch.io import native
    from fastqueeze_tpu_torch.pipeline.blockcodec import _BASE_MAP

    # fused native path: stride subsample + base map + degenerate strip +
    # both histograms in one C pass over the raw ASCII arrays (the numpy
    # glue below costs seconds of copies on a 16M-symbol prefix)
    total = int(block.lengths.sum())
    stride = 1
    if total > target_syms and block.n_reads >= 4:
        stride = int(np.ceil(total / target_syms))
    seq_model = seq_model_from_params(p)
    with span("train.hist"):
        # dense quality-rank vocabulary over the whole prefix: coded
        # symbols are ranks into qvals, not raw phred values ("qmax" below
        # is the max RANK, so all downstream alphabet math is unchanged)
        qvals, lut = qual_vocab(block.qual_flat)
        qmax = max(len(qvals) - 1, 0)
        qmodel = QualModel(alphabet=_qual_alphabet(qmax), init=p.qual_init,
                           inc=p.qual_inc, cap=p.qual_cap, qlevel=p.qlevel,
                           drop_init=p.q_drop_init)
        fused = native.train_prefix(block.seq_flat, block.qual_flat,
                                    block.lengths, stride, seq_model.order,
                                    SEQ_CTX_START, p.qlevel, p.q_drop_init,
                                    lut, qmodel.alphabet)
    if fused is not None:
        shist, qhist = fused

        def sampled_qsyms():
            if stride == 1:
                return lut[block.qual_flat]
            keep = _sample_keep(block.n_reads, stride)
            return lut[block.qual_flat[np.repeat(keep, block.lengths)]]

        lens_s = (block.lengths if stride == 1
                  else block.lengths[_sample_keep(block.n_reads, stride)])
        with _Packing() as packing:
            with span("train.ship"):
                sscale = (max(est_total_syms, int(shist.sum()))
                          / max(int(shist.sum()), 1))
                seq_table = _ship_seq(packing, _narrow_np(
                    _cap_rescale(seq_model, shist), seq_model.cap), shist,
                    sscale, device)
            with span("train.qctx"):
                qual = _select_qctx(
                    p, qmodel, qhist, sampled_qsyms, lens_s, est_total_syms,
                    len(qvals),
                    native_args=(block.qual_flat, block.lengths, stride,
                                 lut), device=device)
            with span("train.ship"):
                return _shipped(packing, seq_table, qual, qmax, qvals)

    with span("train.hist"):
        block = _subsample(block, target_syms)
        codes = _BASE_MAP[block.seq_flat]
        dege = codes == 255
        lengths = block.lengths
        R = block.n_reads
        dege_cnt = np.zeros(R, np.int64)
        n_dege = int(dege.sum())
        if n_dege:
            read_of = np.repeat(np.arange(R), lengths)
            dege_cnt = np.bincount(read_of[dege],
                                   minlength=R).astype(np.int64)
        seq_codes = codes[~dege]
        seq_lens = lengths - dege_cnt
        hist = native.seq_hist(seq_codes, seq_lens, seq_model.order,
                               SEQ_CTX_START)
        if hist is None:
            n = seq_model.n_ctx * seq_model.alphabet
            ctx = seq_ctx_flat(seq_model, seq_codes, seq_lens)
            hist = np.bincount(
                ctx * seq_model.alphabet + seq_codes.astype(np.int64),
                minlength=n)[:n].reshape(seq_model.n_ctx,
                                         seq_model.alphabet)
        qsyms = lut[block.qual_flat]
        qhist = native.qual_hist(qsyms, lengths, p.qlevel,
                                 p.q_drop_init, qmodel.alphabet)
        if qhist is None:
            n = qmodel.n_ctx * qmodel.alphabet
            ctx = qual_ctx_flat(qmodel, qsyms.astype(np.int32), lengths)
            qhist = np.bincount(ctx * qmodel.alphabet + qsyms,
                                minlength=n)[:n].reshape(qmodel.n_ctx,
                                                         qmodel.alphabet)
    with _Packing() as packing:
        with span("train.ship"):
            seq_counts = _cap_rescale(seq_model, hist)
            # tables travel (host->archive->device) in the narrowest dtype
            # the model cap allows; the engine widens to int32 on device
            sscale = (max(est_total_syms, int(hist.sum()))
                      / max(int(hist.sum()), 1))
            seq_table = _ship_seq(packing, _narrow_np(
                seq_counts, seq_model.cap), hist, sscale, device)
        with span("train.qctx"):
            qual = _select_qctx(
                p, qmodel, qhist, lambda: qsyms, lengths, est_total_syms,
                len(qvals),
                native_args=(qsyms, lengths, 1,
                             np.arange(256, dtype=np.uint8)),
                device=device)
        with span("train.ship"):
            return _shipped(packing, seq_table, qual, qmax, qvals)


def train_frozen_blocks(p: CodecParams, blocks,
                        target_syms: int = 16 << 20,
                        est_total_syms: int = 0, device=None) -> Dict:
    """Train from already-parsed blocks (the driver reuses the prefix
    blocks for both training and encoding — no second read/parse pass)."""
    if len(blocks) == 1:
        return train_frozen(p, blocks[0], target_syms, est_total_syms,
                            device)
    combo = FastqBlock(
        n_reads=sum(b.n_reads for b in blocks), ids=[], plus=[],
        seq_flat=np.concatenate([b.seq_flat for b in blocks]),
        qual_flat=np.concatenate([b.qual_flat for b in blocks]),
        lengths=np.concatenate([b.lengths for b in blocks]),
        raw_len=0, final_newline=True)
    return train_frozen(p, combo, target_syms, est_total_syms, device)


def _narrow_np(counts: np.ndarray, cap: int) -> np.ndarray:
    if cap < (1 << 8):
        return counts.astype(np.uint8)
    if cap < (1 << 16):
        return counts.astype(np.uint16)
    return counts


def _pack_counts(a: np.ndarray, level: int = 9,
                 estimate: bool = False,
                 priced: Optional[Dict] = None) -> Dict:
    """Minimal-width serialization: table caps bound every count, so u8/u16
    usually suffice.  u16 tables are split into low/high byte planes
    (counts are mostly small, so the high plane is near-constant) —
    measured ~45% smaller than whole-array compression on trained qual
    tables.  Each plane set ships the smaller of bz2-9 and zlib-9: bz2
    wins 10-40% on trained count tables (measured on the 2^17..2^20-row
    hashed qctx chains) at ~0.05-0.7 s per table.

    ``estimate=True`` is the train-time cost model's path: bz2-9 only
    (the same codec archives actually ship, so candidate blob pricing is
    exact — a zlib-1 estimate overpriced deep hashed tables ~2x and made
    the ladder reject candidates that win at the shipped size).
    ``priced``: this table's ``estimate=True`` pack (:func:`_priced`),
    whose bz2-9 blob is taken instead of compressing the table again."""
    hi = int(a.max()) if a.size else 0
    dt = np.uint8 if hi < 0x100 else (np.uint16 if hi < 0x10000 else np.int32)
    u = np.ascontiguousarray(a, dt)
    # bz2 won every measured trained table >= 1 MB; the zlib-9
    # cross-check is only worth its cost on small tables (zlib-9 runs
    # ~0.1 s/MB — pointless on an 80 MB deep-qctx table bz2 wins anyway)
    cross = not estimate and u.nbytes <= (8 << 20)
    if dt == np.uint16:
        lo_raw = (u & 0xFF).astype(np.uint8).tobytes()
        hb_raw = (u >> 8).astype(np.uint8).tobytes()
        if priced is not None:
            n = int.from_bytes(priced["blob"][:4], "little")
            lo_b, hb_b = priced["blob"][4:4 + n], priced["blob"][4 + n:]
        else:
            lo_b, hb_b = bz2.compress(lo_raw, 9), bz2.compress(hb_raw, 9)
        lo, hb, enc = lo_b, hb_b, "pb"
        if cross:
            lo_z = zlib.compress(lo_raw, level)
            hb_z = zlib.compress(hb_raw, level)
            if len(lo_z) + len(hb_z) < len(lo_b) + len(hb_b):
                lo, hb, enc = lo_z, hb_z, "p9"
        return {"shape": list(a.shape), "dtype": np.dtype(dt).str,
                "enc": enc,
                "blob": len(lo).to_bytes(4, "little") + lo + hb}
    raw = u.tobytes()
    b = priced["blob"] if priced is not None else bz2.compress(raw, 9)
    if cross:
        z = zlib.compress(raw, level)
        if len(z) < len(b):
            return {"shape": list(a.shape), "dtype": np.dtype(dt).str,
                    "enc": "z", "blob": z}
    return {"shape": list(a.shape), "dtype": np.dtype(dt).str,
            "enc": "b", "blob": b}


def _unpack_counts(blob: bytes, dtype: str, enc: str) -> np.ndarray:
    if enc in ("p9", "pb"):
        dec = bz2.decompress if enc == "pb" else zlib.decompress
        n = int.from_bytes(blob[:4], "little")
        lo = np.frombuffer(dec(blob[4:4 + n]), np.uint8)
        hb = np.frombuffer(dec(blob[4 + n:]), np.uint8)
        return (hb.astype(np.uint16) << 8) | lo
    if enc == "b":
        return np.frombuffer(bz2.decompress(blob), dtype)
    return np.frombuffer(zlib.decompress(blob), dtype)


def serialize_frozen(frozen: Dict) -> bytes:
    """The MODEL section of ``frozen``.  A freshly trained dict's tables
    are packed on its packing thread (:class:`_Packing`): this joins it,
    and raises its error.  The result is a pure function of the tables, so
    it is cached on the frozen dict (which itself lives in the training
    memo): repeat compressions of the same input pay it once."""
    ser = frozen.get("_ser")
    if ser is not None:
        return ser
    packing = frozen.get("_pack")
    if packing is not None:
        try:
            seq, qual = packing.result()
        except BaseException:
            # a failed pack is not memoized: the next compress retrains
            for k in [k for k, v in _TRAIN_CACHE.items() if v[0] is frozen]:
                del _TRAIN_CACHE[k]
            raise
    else:
        seq = _pack_counts(np.asarray(frozen["seq_counts"]))
        qual = _pack_counts(np.asarray(frozen["qual_counts"]))
    meta = {"qmax": frozen["qmax"],
            "qvals": np.asarray(frozen["qvals"], np.uint8).tolist(),
            "seq_shape": seq["shape"], "seq_dtype": seq["dtype"],
            "seq_enc": seq["enc"],
            "qual_shape": qual["shape"], "qual_dtype": qual["dtype"],
            "qual_enc": qual["enc"]}
    out = io.BytesIO()
    out.write(write_tlv(_TAG_META, json.dumps(meta).encode()))
    out.write(write_tlv(_TAG_SEQ, seq["blob"]))
    out.write(write_tlv(_TAG_QUAL, qual["blob"]))
    frozen["_ser"] = out.getvalue()
    return frozen["_ser"]


def join_packing(frozen: Optional[Dict]) -> None:
    """Wait until the packing thread of ``frozen`` (if any) has ended, so
    that a compress call that fails leaves no thread behind; its error is
    :func:`serialize_frozen`'s to raise."""
    packing = frozen.get("_pack") if frozen is not None else None
    if packing is not None:
        packing.wait()


# Content-keyed deserialization memo: repeated archive opens (benchmark
# loops, servers, the multi-file driver, threaded decode) reuse one frozen
# dict — which also carries the quantized host tables and uploaded device
# tables in its _hostq/_dev caches, so those are paid once per content too.
_DESER_CACHE: "dict" = {}
_DESER_CACHE_MAX = 4


def deserialize_frozen(blob: bytes) -> Dict:
    import hashlib
    key = hashlib.md5(blob).hexdigest()
    hit = _DESER_CACHE.pop(key, None)
    count("deser_cache_hit" if hit is not None else "deser_cache_miss")
    if hit is not None:
        _DESER_CACHE[key] = hit                 # LRU touch
        return hit
    out = _deserialize_frozen_impl(blob)
    _DESER_CACHE[key] = out
    while len(_DESER_CACHE) > _DESER_CACHE_MAX:
        _DESER_CACHE.pop(next(iter(_DESER_CACHE)))
    return out


def _deserialize_frozen_impl(blob: bytes) -> Dict:
    import zlib
    try:
        sections = dict(iter_tlv(blob))
        meta = json.loads(sections[_TAG_META].decode())
        seq = _unpack_counts(sections[_TAG_SEQ], meta["seq_dtype"],
                             meta.get("seq_enc", "z"))
        qual = _unpack_counts(sections[_TAG_QUAL], meta["qual_dtype"],
                              meta.get("qual_enc", "z"))
        return {"qmax": meta["qmax"],
                "qvals": np.asarray(
                    meta.get("qvals", list(range(meta["qmax"] + 1))),
                    np.uint8),
                "seq_counts": seq.reshape(meta["seq_shape"]),
                "qual_counts": qual.reshape(meta["qual_shape"])}
    except (zlib.error, json.JSONDecodeError, KeyError, TypeError,
            UnicodeDecodeError) as e:
        # corruption in the MODEL section must surface like every other
        # corrupt-archive path (the fuzz tests enforce ValueError family)
        raise ValueError(f"corrupt MODEL section: {e}") from e


def device_tables(frozen: Dict, qual_alphabet: int, init: int, device,
                  qual: bool = True):
    """(seq, qual) frozen tables quantized on ``device`` by K1
    (engine.FrozenTable), the qual table first padded to the block's
    alphabet with ``init`` columns.  Built once per table and device and
    cached inside the frozen dict (the tables are identical for every
    block of an archive).  qual=False: the seq table alone, None for qual
    (the ctx-sharded decode keeps that one in row shards,
    device_shard_tables)."""
    from fastqueeze_tpu_torch.ops.engine import frozen_table, resolve_device
    dev = str(resolve_device(device))
    cache = frozen.setdefault("_dev", {})
    skey = ("seq", dev)
    if skey not in cache:
        cache[skey] = _settled(frozen_table(frozen["seq_counts"], dev), dev)
    qkey = ("qual", qual_alphabet, init, dev)
    if not qual:
        return cache[skey], None
    if qkey not in cache:
        cache[qkey] = _settled(frozen_table(
            fit_qual_alphabet(np.asarray(frozen["qual_counts"]),
                              qual_alphabet, init), dev), dev)
    return cache[skey], cache[qkey]


def device_shard_tables(frozen: Dict, qual_alphabet: int, init: int,
                        devices) -> list:
    """The qual table (padded as device_tables pads it) split by rows over
    ``devices`` (the ctx-sharded decode, parallel/mesh.py): shard s's
    rows quantized by K1 on devices[s] (quantization is row-local), one
    engine.FrozenTable a shard, cached in the frozen dict."""
    from fastqueeze_tpu_torch.ops.engine import frozen_table, resolve_device
    devs = [str(resolve_device(d)) for d in devices]
    key = ("qual_shards", qual_alphabet, init, tuple(devs))
    cache = frozen.setdefault("_dev", {})
    if key not in cache:
        full = fit_qual_alphabet(np.asarray(frozen["qual_counts"]),
                                 qual_alphabet, init)
        n = full.shape[0] // len(devs)
        cache[key] = [_settled(frozen_table(full[s * n:(s + 1) * n], d), d)
                      for s, d in enumerate(devs)]
    return cache[key]


def _settled(table, device):
    """``table`` once the device has finished making it: the cached tables
    are shared by every block, and block workers run on CUDA streams of
    their own (parallel/mesh.device_cycled)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(torch.device(device)).synchronize()
    return table


def device_raw_tables(frozen: Dict, qual_alphabet: int, init: int, device):
    """(seq, qual) raw (n_ctx, A) int32 count tables on ``device``, the
    qual table padded as device_tables pads it: the starting tables of the
    adaptive walk when frozen_adapt keeps adapting from the snapshot (the
    walks copy them).  Counterpart of fastqueeze_tpu/pipeline/frozen.py
    frozen_dev_tables; cached in the frozen dict like device_tables."""
    import torch
    from fastqueeze_tpu_torch.ops.engine import resolve_device
    dev = str(resolve_device(device))
    cache = frozen.setdefault("_dev", {})
    skey = ("seq_raw", dev)
    if skey not in cache:
        cache[skey] = _settled(torch.tensor(
            np.asarray(frozen["seq_counts"]), dtype=torch.int32,
            device=dev), dev)
    qkey = ("qual_raw", qual_alphabet, init, dev)
    if qkey not in cache:
        cache[qkey] = _settled(torch.tensor(
            fit_qual_alphabet(np.asarray(frozen["qual_counts"]),
                              qual_alphabet, init),
            dtype=torch.int32, device=dev), dev)
    return cache[skey], cache[qkey]


def stage_tables(frozen: Dict, p: CodecParams, device) -> None:
    """Put a freshly trained archive's tables on ``device`` before the
    first block: quantized (device_tables) for coding against the
    snapshot, raw counts (device_raw_tables) with frozen_adapt."""
    tables = device_raw_tables if p.frozen_adapt else device_tables
    tables(frozen, _qual_alphabet(frozen["qmax"]), p.qctx_eff_init(), device)


def frozen_host_cums(frozen: Dict, qual_alphabet: int, init: int):
    """Host-resident quantized cumfreq tables for the native frozen coder
    (ops/host_frozen.py) — the host twin of device_tables.  Quantized
    once per archive open and cached in the frozen dict."""
    from fastqueeze_tpu_torch.ops import host_frozen
    cache = frozen.setdefault("_hostq", {})
    if "seq" not in cache:
        cache["seq"] = host_frozen.quantize(
            np.asarray(frozen["seq_counts"], np.int32))
    qkey = ("qual", qual_alphabet, init)
    if qkey not in cache:
        cache[qkey] = host_frozen.quantize(np.asarray(
            fit_qual_alphabet(np.asarray(frozen["qual_counts"]),
                              qual_alphabet, init), np.int32))
    return cache["seq"], cache[qkey]


def fit_qual_alphabet(counts: np.ndarray, alphabet: int,
                      init: int) -> np.ndarray:
    """Pad/passthrough the frozen qual table to a block's alphabet (a later
    block may contain higher quality symbols than the training prefix)."""
    have = counts.shape[1]
    if have == alphabet:
        return counts
    if have > alphabet:
        raise ValueError("frozen qual table wider than block alphabet")
    pad = np.full((counts.shape[0], alphabet - have), init, counts.dtype)
    return np.concatenate([counts, pad], axis=1)
