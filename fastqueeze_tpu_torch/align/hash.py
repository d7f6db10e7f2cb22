"""Batched seed-and-extend aligner: the tier chain over a block's reads.

Copied from fastqueeze_tpu/align/hash.py (AlignConfig, AlignResult,
Aligner.align and its tiers): tier 1 forward over every read, RC only on
the reads forward failed (or both strands with both_strands), tier 2 a
deeper multi-seed rescue of the still-unmapped reads, tier 3 the indel
tier when max_indel > 0.  Each tier's batches go through K8
(ops.kernels.align_batch) and K9 (ops.kernels.indel_batch); the PE
mate rescue (Aligner.rescue_mates, -I) through K10
(ops.kernels.window_batch).  With FASTQUEEZE_FUSED_ALIGN=1 the kernel
route runs the JAX package's fused flow instead: tier 1 both strands
over every batch (K8), then one K14 (ops.kernels.rescue_indel_fused) a
batch for the rescue and indel tiers over the batch's grids, which stay
on the device; the decisions are the same.  Reads longer than
align_max_len skip the read-level tiers (the long-read chunk tier of
pipeline/aligned.py maps them in pieces through this same call).

Routing is an execution choice (the outputs that reach the archive are
identical): on a CUDA device the kernels run, unless
FASTQUEEZE_ALIGN_EXEC=host sends the batches to the native host mirror
(native/alignhost.cpp), the oracle; on the CPU the native mirror is the
default and FASTQUEEZE_ALIGN_EXEC=device runs the kernels' plain PyTorch
versions.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from fastqueeze_tpu_torch.align.index import RefIndex
from fastqueeze_tpu_torch.config import CodecParams

@dataclass(frozen=True)
class AlignConfig:
    k: int
    stride: int
    n_cand: int          # candidate positions verified per read (per seed)
    max_mis: int
    both_strands: int
    lp: int              # padded read length (multiple of 16)
    n_seeds: int = 1     # least-frequent seeds that contribute candidates
    excl_bp: int = 0     # mask +-excl_bp around a picked seed before the
                         # next pick (an error spoils ~k/stride seeds)
    strand: str = "both"     # "fwd" / "rc": one strand only
    probe_k: int = 1024      # two-probe-word prefilter keeps the top-K
                             # candidates when the list is > 2K deep


class AlignResult(NamedTuple):
    mapped: np.ndarray    # (R,) bool
    pos: np.ndarray       # (R,) int64 window start in ref coords
    is_rev: np.ndarray    # (R,) bool
    mis_mask: np.ndarray  # (R, Lp) bool, True at mismatch (window coords)
    # indel tier: split s and signed gap g (g > 0: the read skips g ref
    # bases at s; g < 0: |g| inserted read bases at s), and an optional
    # second op (s2, g2).  None = every read gapless.
    gap_pos: Optional[np.ndarray] = None
    gap_len: Optional[np.ndarray] = None
    gap_pos2: Optional[np.ndarray] = None
    gap_len2: Optional[np.ndarray] = None
    # the long-read chunk tier: (reads, offs, clens, AlignResult of the
    # chunks) in pipeline.blockcodec._lr_grid order, or None
    chunks: Optional[tuple] = None


def _gridify(codes_flat, dege_flat, lengths, lp):
    """Flat per-block arrays -> zero-padded (R, lp) grids."""
    R = len(lengths)
    offs = np.cumsum(lengths) - lengths
    gi = (np.arange(int(lengths.sum()), dtype=np.int64)
          - np.repeat(offs, lengths))
    rows = np.repeat(np.arange(R), lengths)
    codes = np.zeros((R, lp), np.uint8)
    dege = np.zeros((R, lp), bool)
    codes[rows, gi] = codes_flat
    dege[rows, gi] = dege_flat
    return codes, dege


def lp_bucket(max_len: int) -> int:
    """Bucketed padded read length ({1, 1.5} x powers of two, >= 32, x16
    aligned), as the JAX package pads."""
    b = 32
    while b < max_len:
        b = b + (b >> 1) if (b & (b - 1)) == 0 else (b // 3) * 4
    return b


def route_host(device, mesh_n: int = 0) -> bool:
    """True: the native host mirror aligns; False: K8/K9 (their plain
    versions for a CPU device).  FASTQUEEZE_ALIGN_EXEC=host|device
    decides; else the kernels on a CUDA device or with an explicit mesh
    request (``mesh_n``), the mirror otherwise."""
    mode = os.environ.get("FASTQUEEZE_ALIGN_EXEC", "")
    if mode == "host":
        return True
    if mode == "device":
        return False
    return not mesh_n and torch.device(device).type != "cuda"


class Aligner:
    """Holds the index arrays (host copies for the native mirror; device
    copies built once per device) and runs the tier chain."""

    # reads a launch: tier 1 (and the fused flow's K8 + K14 batch), and
    # the rescue and indel tiers.  Free choices (a read's result does not
    # depend on its batch): on an H100 the warp kernels take 0.057 us a
    # rescue read at 4,096 reads against 0.234 at 512, K9 0.267 against
    # 0.832 (chip_smoke.py --aligner, its batch sweep)
    BATCH = 4096
    RESCUE_BATCH = 4096

    def __init__(self, idx: RefIndex, params: CodecParams):
        if idx.n_positions >= (1 << 31) or idx.ref_len >= (1 << 31):
            raise ValueError("reference too large for a single-chip index")
        if idx.k > 31:
            raise ValueError("aligner supports seed_len <= 31")
        self.params = params
        self.ref_len = idx.ref_len
        self.k = idx.k
        self.wide = idx.k > 15
        keys = np.asarray(idx.keys, np.uint64)
        if not len(keys):
            keys = np.zeros(1, np.uint64)
        offs = np.asarray(idx.offsets, np.int32)
        if len(offs) < 2:
            offs = np.zeros(2, np.int32)
        pos = np.asarray(idx.positions, np.int32)
        if not len(pos):
            pos = np.zeros(1, np.int32)
        # first-level prefix table: bounds the per-seed binary search to one
        # bucket
        l1_bits = min(2 * self.k, 18)
        self._l1_shift = max(0, 2 * self.k - l1_bits)
        l1 = np.searchsorted(
            keys >> np.uint64(self._l1_shift),
            np.arange((1 << l1_bits) + 1, dtype=np.uint64)).astype(np.int32)
        max_bucket = int(np.diff(l1).max()) if len(l1) > 1 else 1
        self._search_steps = max(1, int(np.ceil(np.log2(max_bucket + 1))))
        self._h_keys = keys
        self._h_offsets = offs
        self._h_positions = pos
        # padded so the native inner loops can fetch up to lp/16 + 1 words
        # past the true end without clamping (masked-out slots only); the
        # device copy has no pad and the kernels clamp instead
        self._h_pad_words = 1026
        self._h_packed = np.concatenate([idx.packed.astype(np.uint32),
                                         np.zeros(self._h_pad_words,
                                                  np.uint32)])
        self._h_l1 = l1
        self._dev = {}

    def dev_index(self, device):
        """The index on ``device`` (ops.kernels.AlignIndex), uploaded once."""
        from fastqueeze_tpu_torch.ops.kernels import AlignIndex
        device = torch.device(device)
        ix = self._dev.get(device)
        if ix is None:
            keys = (self._h_keys.view(np.int64) if self.wide
                    else self._h_keys.astype(np.int32))
            packed = self._h_packed[:len(self._h_packed) - self._h_pad_words]
            put = lambda a: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a)).to(device)
            ix = AlignIndex(put(keys), put(self._h_offsets),
                            put(self._h_positions), put(packed.view(np.int32)),
                            put(self._h_l1), self._l1_shift,
                            self._search_steps, self.ref_len)
            self._dev[device] = ix
        return ix

    def align(self, codes_flat: np.ndarray, dege_flat: np.ndarray,
              lengths: np.ndarray, device="cuda", allow_indel: bool = True,
              max_indel: Optional[int] = None) -> AlignResult:
        """codes_flat: concatenated 2-bit read codes (degenerate bases as
        0); dege_flat: degenerate-base mask; lengths: per read.  max_indel
        overrides p.max_indel for this call (the long-read chunk tier runs
        its own gap budget, longread_indel); allow_indel=False turns the
        indel tier off."""
        R = len(lengths)
        if R == 0 or self.ref_len < self.k:
            return AlignResult(np.zeros(R, bool), np.zeros(R, np.int64),
                               np.zeros(R, bool), np.zeros((R, 32), bool))
        p = self.params
        eff_indel = p.max_indel if max_indel is None else max_indel
        if int(lengths.max()) > p.align_max_len:
            return self._align_short(codes_flat, dege_flat, lengths, device,
                                     allow_indel, max_indel, eff_indel)
        lp = lp_bucket(int(lengths.max()))
        cfg = AlignConfig(k=self.k, stride=p.seed_stride,
                          n_cand=p.seed_max_occ, max_mis=p.max_mis,
                          both_strands=p.both_strands, lp=lp,
                          probe_k=p.seed_probe_k)
        # tiers 2 and 3: candidates from several spatially diverse
        # least-frequent seeds and a deeper list per seed
        deep = dataclasses.replace(cfg, n_cand=p.seed_big_occ,
                                   n_seeds=p.rescue_seeds,
                                   excl_bp=p.seed_excl_bp, probe_k=1024)
        rescue_on = p.seed_big_occ > cfg.n_cand and p.rescue_seeds > 0
        indel_on = eff_indel > 0 and allow_indel
        G = min(eff_indel, lp - 1)
        run = _Tiers(self, codes_flat, dege_flat, lengths, lp, device)
        out = (np.zeros(R, bool), np.zeros(R, np.int64), np.zeros(R, bool),
               np.zeros((R, lp), bool))
        gaps = (tuple(np.zeros(R, np.int32) for _ in range(4)) if indel_on
                else ())
        if not run.host and os.environ.get("FASTQUEEZE_FUSED_ALIGN") == "1":
            run.fused(cfg, deep if rescue_on else None, deep,
                      G if indel_on else 0, p.indel_ops if indel_on else 0,
                      out, gaps)
            return AlignResult(*out, *gaps)

        # tier 1: forward over every read, RC only over the reads forward
        # failed (RC is a fallback in the reference), or both strands
        if p.both_strands:
            run.tier(cfg, np.arange(R), out, self.BATCH)
        else:
            run.tier(dataclasses.replace(cfg, strand="fwd"), np.arange(R),
                     out, self.BATCH)
            todo = np.flatnonzero(~out[0] & (lengths >= self.k))
            if len(todo):
                run.tier(dataclasses.replace(cfg, strand="rc"), todo, out,
                         self.BATCH)
        # tier 2: the rescue of the unmapped reads
        if rescue_on:
            todo = np.flatnonzero(~out[0] & (lengths >= self.k))
            if len(todo):
                run.tier(deep, todo, out, self.RESCUE_BATCH)
        # tier 3: indel rescue of the still-unmapped reads (-q)
        if indel_on:
            todo = np.flatnonzero(~out[0] & (lengths >= self.k))
            if len(todo):
                run.indel(deep, G, p.indel_ops, todo, out, gaps)
        return AlignResult(*out, *gaps)

    def _align_short(self, codes_flat, dege_flat, lengths, device,
                     allow_indel, max_indel, eff_indel) -> AlignResult:
        """A batch with reads longer than align_max_len: the others are
        aligned on their own and the long ones stay unmapped at read level
        (the chunk tier maps them; gridding them would blow up the (R, lp)
        batch)."""
        R = len(lengths)
        short = lengths <= self.params.align_max_len
        sel = np.flatnonzero(short)
        lp = lp_bucket(int(lengths[sel].max()) if len(sel) else 32)
        gaps = ((None,) * 4 if eff_indel <= 0
                else tuple(np.zeros(R, np.int32) for _ in range(4)))
        res = AlignResult(np.zeros(R, bool), np.zeros(R, np.int64),
                          np.zeros(R, bool), np.zeros((R, lp), bool), *gaps)
        if len(sel):
            keep = np.repeat(short, lengths)
            sub = self.align(codes_flat[keep], dege_flat[keep],
                             lengths[sel], device, allow_indel, max_indel)
            for dst, src in zip(res[:4], sub[:4]):
                dst[sel] = src
            if gaps[0] is not None and sub.gap_pos is not None:
                # indel reads' masks are in spliced-window coordinates:
                # without their gap fields they would decode as gapless
                for dst, src in zip(res[4:8], sub[4:8]):
                    dst[sel] = src
        return res

    def rescue_mates(self, codes_flat: np.ndarray, dege_flat: np.ndarray,
                     lengths: np.ndarray, res: AlignResult, max_insr: int,
                     device="cuda") -> AlignResult:
        """PE consistent-pairing rescue: an unmapped read whose interleaved
        mate (read i ^ 1) mapped is re-verified at every offset of a
        C = min(4096, 2 * max_insr + 128) window centred on the mate's
        position, both strands (K10, or the native mirror).  Rescued reads
        are gapless; the gap fields and the chunks carry over unchanged
        (reads longer than the grid, the long reads, are skipped)."""
        from fastqueeze_tpu_torch.io import native
        from fastqueeze_tpu_torch.ops import kernels
        R = len(lengths)
        if R < 2 or max_insr <= 0:
            return res
        mate = np.arange(R) ^ 1
        lp = res.mis_mask.shape[1]
        todo = np.flatnonzero(~res.mapped & res.mapped[mate]
                              & (lengths > 0) & (lengths <= lp))
        if not len(todo):
            return res
        C = min(4096, 2 * max_insr + 128)
        centers = res.pos[mate[todo]].astype(np.int32)
        if route_host(device, self.params.mesh_n):
            roffs = (np.cumsum(lengths) - lengths).astype(np.int64)
            m, p_, r, mm = native.window_batch(
                self._h_packed, self.ref_len, codes_flat, dege_flat,
                roffs[todo], lengths[todo], centers, lp, C,
                self.params.max_mis)
        else:
            # grid only the rescue candidates, all in one launch
            off = np.cumsum(lengths) - lengths
            n = lengths[todo]
            idx = np.repeat(off[todo], n) + (
                np.arange(int(n.sum()), dtype=np.int64)
                - np.repeat(np.cumsum(n) - n, n))
            c, d = _gridify(codes_flat[idx], dege_flat[idx], n, lp)
            put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
            out = kernels.window_batch(
                self.dev_index(device).packed, self.ref_len, put(c), put(d),
                put(n.astype(np.int32)), put(centers), C,
                self.params.max_mis)
            m, p_, r, mm = (_np(x) for x in out)
        mapped, pos = res.mapped.copy(), res.pos.copy()
        is_rev, mis_mask = res.is_rev.copy(), res.mis_mask.copy()
        upd = todo[m]
        mapped[upd] = True
        pos[upd] = p_[m]
        is_rev[upd] = r[m]
        mis_mask[upd] = mm[m]
        return AlignResult(mapped, pos, is_rev, mis_mask, res.gap_pos,
                           res.gap_len, res.gap_pos2, res.gap_len2,
                           res.chunks)


class _Tiers:
    """One align() call's batches: flat arrays for the native mirror, or
    the (R, lp) grids on the device for K8/K9, built on first use."""

    def __init__(self, al: Aligner, codes_flat, dege_flat, lengths, lp,
                 device):
        self.al = al
        self.codes_flat, self.dege_flat = codes_flat, dege_flat
        self.lengths = lengths
        self.roffs = (np.cumsum(lengths) - lengths).astype(np.int64)
        self.lp = lp
        self.device = torch.device(device)
        self.host = route_host(self.device, al.params.mesh_n)
        self._grids = None

    def _native_args(self, cfg: AlignConfig, rows):
        al = self.al
        return (al._h_keys, al._h_offsets, al._h_positions, al._h_packed,
                al._h_l1, al._l1_shift, al._search_steps, al.ref_len,
                self.codes_flat, self.dege_flat, self.roffs[rows],
                self.lengths[rows], cfg.lp, cfg.k, cfg.stride, cfg.n_cand,
                cfg.max_mis, cfg.n_seeds, cfg.excl_bp, cfg.probe_k)

    def _batches(self, rows, batch):
        if self._grids is None:
            c, d = _gridify(self.codes_flat, self.dege_flat, self.lengths,
                            self.lp)
            dev = self.device
            self._grids = (torch.from_numpy(c).to(dev),
                           torch.from_numpy(d).to(dev),
                           torch.from_numpy(self.lengths.astype(np.int32))
                           .to(dev))
        codes, dege, lens = self._grids
        for s in range(0, len(rows), batch):
            sel = rows[s:s + batch]
            r = torch.from_numpy(sel).to(self.device)
            yield sel, codes[r], dege[r], lens[r]

    def tier(self, cfg: AlignConfig, rows, out, batch: int) -> None:
        from fastqueeze_tpu_torch.io import native
        from fastqueeze_tpu_torch.ops import kernels
        mapped, pos, is_rev, mis_mask = out
        if self.host:
            sm = {"fwd": 0, "rc": 1, "both": 2}[cfg.strand]
            res = native.align_batch(*self._native_args(cfg, rows), sm,
                                     int(cfg.both_strands))
            parts = [(rows, res)]
        else:
            ix = self.al.dev_index(self.device)
            parts = [(sel, kernels.align_batch(c, d, ln, ix, cfg))
                     for sel, c, d, ln in self._batches(rows, batch)]
        for sel, (m, p_, r, mm) in parts:
            mapped[sel] = _np(m)
            pos[sel] = _np(p_)
            is_rev[sel] = _np(r)
            mis_mask[sel] = _np(mm)

    def indel(self, cfg: AlignConfig, G: int, ops: int, rows, out,
              gaps) -> None:
        from fastqueeze_tpu_torch.io import native
        from fastqueeze_tpu_torch.ops import kernels
        if self.host:
            parts = [(rows, native.indel_batch(*self._native_args(cfg, rows),
                                               G, ops))]
        else:
            ix = self.al.dev_index(self.device)
            parts = [(sel, kernels.indel_batch(c, d, ln, ix, cfg, G, ops))
                     for sel, c, d, ln in self._batches(
                         rows, Aligner.RESCUE_BATCH)]
        mapped, pos, is_rev, mis_mask = out
        for sel, res in parts:
            f, p_, s1, g1, s2, g2, r, mm = (_np(x) for x in res)
            upd = sel[f]
            mapped[upd] = True
            pos[upd] = p_[f]
            for dst, src in zip(gaps, (s1, g1, s2, g2)):
                dst[upd] = src[f]
            is_rev[upd] = r[f]
            mis_mask[upd] = mm[f]


    def fused(self, cfg: AlignConfig, cfg2, cfg3, G: int, ops: int, out,
              gaps) -> None:
        """hash._align_device_fused: tier 1 on both strands over every
        batch (K8), one copy of the mapped bits, then one K14 a batch over
        its grids (still on the device) with the unmapped reads of length
        >= k as the todo list, padded to a power of two >= 128; then every
        result is copied back."""
        from fastqueeze_tpu_torch.ops import kernels
        ix = self.al.dev_index(self.device)
        jobs = [(sel, c, d, ln, kernels.align_batch(c, d, ln, ix, cfg))
                for sel, c, d, ln in self._batches(
                    np.arange(len(self.lengths)), Aligner.BATCH)]
        m1 = [_np(j[4][0]) for j in jobs]          # round trip 1
        phase_b = []
        for (sel, c, d, ln, _), m in zip(jobs, m1):
            todo = np.flatnonzero(~m & (self.lengths[sel] >= self.al.k))
            if (cfg2 is None and not ops) or not len(todo):
                continue
            cap = 128
            while cap < len(todo):
                cap <<= 1
            idxv = np.zeros(cap, np.int32)
            dov = np.zeros(cap, bool)
            idxv[:len(todo)] = todo
            dov[:len(todo)] = True
            put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
            phase_b.append((sel[todo], kernels.rescue_indel_fused(
                c, d, ln, put(idxv), put(dov), ix, cfg2, cfg3, G, ops)))
        mapped, pos, is_rev, mis_mask = out
        for (sel, *_, res), m in zip(jobs, m1):      # round trip 2
            mapped[sel] = m
            pos[sel] = _np(res[1])
            is_rev[sel] = _np(res[2])
            mis_mask[sel] = _np(res[3])
        for rows, res in phase_b:
            k = len(rows)
            m2, p2, r2, mm2, f, pi, s1, g1, s2, g2, ri, mmi = (
                _np(x)[:k] for x in res)
            upd = rows[m2]
            mapped[upd] = True
            pos[upd] = p2[m2]
            is_rev[upd] = r2[m2]
            mis_mask[upd] = mm2[m2]
            upd = rows[f]
            mapped[upd] = True
            pos[upd] = pi[f]
            for dst, src in zip(gaps, (s1, g1, s2, g2)):
                dst[upd] = src[f]
            is_rev[upd] = ri[f]
            mis_mask[upd] = mmi[f]


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x
