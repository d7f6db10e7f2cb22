"""The decomposition the aligner's warp kernels rest on, on the CPU.

K8 (align_batch), K9 (indel_batch) and K14 (rescue_indel_fused) run one
warp a read (csrc/seed_search.cuh, csrc/align_read.cuh): the 32 lanes
look up the sampled seeds side by side, each pick is a warp argmin on
(occ, sample), the lanes load and probe a pick's candidates 32 at a time,
a stable counting sort by (probe count, index) places each chunk's
survivors with a rank among the chunk's lanes of the same bucket, and
the verify runs in rounds of 32 order entries, each lane counting one
entry with the round-start best as its early exit, the serial rules then
applied in lane order.  The indel tier fills its compare rows 32 columns
at a time with a carry and picks every split by a warp argmin on (total,
split).

This file holds a plain mirror of that decomposition, lane by lane (never
on the card path), and holds it to the JAX package's _one_strand,
_align_batch, _indel_batch and _rescue_indel_fused and to the port's plain
versions (which tests/test_torch_gpu.py holds the kernels to), on seeded
reads built to hit every rule: the prefilter off, no valid candidate,
every candidate pruned, probe-count ties across a round boundary, the
K cut and best == 0 landing mid-round, overlapping +-excl_bp masks, k = 22
keys, Lp 1024 (more samples than lanes) and indel ties between the two
anchorings.  The mirror counts which rules fired; the last test asserts
each one fires on these reads.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.align import hash as jh
from fastqueeze_tpu.align import index as jidx
from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu_torch.align import hash as th
from fastqueeze_tpu_torch.align import index as tidx
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.ops import kernels

LANES = 32
ILP = 4                       # seed_search.cuh kIlp
BIG = kernels.ALIGN_BIG
NONE = (1 << 31) - 1          # seed_search.cuh kNone
M32 = 0xFFFFFFFF
_LANE = np.arange(LANES)
EVENTS = collections.Counter()   # rules the mirror saw fire


# --- warp primitives ---------------------------------------------------------

def warp_argmin(v, i, pay=None):
    """The butterfly of seed_search.cuh warp_argmin: lexicographic (v, i)
    minimum, every lane ends with it."""
    v, i = np.array(v, np.int64), np.array(i, np.int64)
    pay = np.zeros(LANES, np.int64) if pay is None else np.array(pay)
    for o in (16, 8, 4, 2, 1):
        v2, i2, p2 = v[_LANE ^ o], i[_LANE ^ o], pay[_LANE ^ o]
        take = (v2 < v) | ((v2 == v) & (i2 < i))
        v, i, pay = (np.where(take, v2, v), np.where(take, i2, i),
                     np.where(take, p2, pay))
    assert (v == v[0]).all() and (i == i[0]).all()
    return int(v[0]), int(i[0]), int(pay[0])


def range_argmin(lo, hi, f):
    """align_read.cuh range_argmin: lane l scans s = lo + l, lo + l + 32,
    ... <= hi keeping its first strict minimum, then the warp argmin."""
    v = np.full(LANES, NONE, np.int64)
    at = np.full(LANES, NONE, np.int64)
    for s0 in range(lo, hi + 1, LANES):
        s = s0 + _LANE
        live = s <= hi
        t = np.where(live, f(np.minimum(s, hi)), NONE)
        better = live & (t < v)
        v, at = np.where(better, t, v), np.where(better, s, at)
    tb, sb, _ = warp_argmin(v, at)
    return tb, sb


# --- the index on the host ---------------------------------------------------

class Ix:
    """Aligner.dev_index's arrays as numpy (u32 words and keys widened)."""

    def __init__(self, tal):
        ix = tal.dev_index("cpu")
        self.keys = ix.keys.numpy().astype(np.int64) & (
            -1 if tal.wide else M32)
        self.offsets = ix.offsets.numpy().astype(np.int64)
        self.positions = ix.positions.numpy().astype(np.int64)
        self.packed = ix.packed.numpy().astype(np.int64) & M32
        self.l1 = ix.l1.numpy().astype(np.int64)
        self.l1_shift, self.steps = ix.l1_shift, ix.search_steps
        self.ref_len = ix.ref_len
        self.nk, self.npos, self.nw = (len(self.keys), len(self.positions),
                                       len(self.packed))

    def word(self, w):
        return self.packed[np.clip(w, 0, self.nw - 1)]

    def base(self, idx):
        idx = np.asarray(idx, np.int64)
        return (self.word(idx >> 4) >> (2 * (15 - (idx & 15)))) & 3


def _mis2bit(x):
    """Differing 2-bit slots of u32 XOR words (seed_search.cuh mis2bit)."""
    return np.bitwise_count(np.asarray((x | (x >> 1)) & 0x55555555,
                                       np.uint64)).astype(np.int64)


def _frame(arr, W, j, sh):
    """seed_search.cuh frame_word over lanes: sh (32,) = 2 * (cand & 15)."""
    a = int(arr[j - 1]) if 1 <= j <= W else 0
    b = int(arr[j]) if j < W else 0
    shl = 32 - np.maximum(sh, 1)
    hi = np.where((j >= 1) & (sh > 0), (a << shl) & M32, 0)
    return hi | (b >> sh)


def _word_mis(ix, rw, mw, W, j, cp):
    sh = 2 * (cp & 15)
    refw = ix.word((cp >> 4) + j)
    return _mis2bit((_frame(rw, W, j, sh) ^ refw) & _frame(mw, W, j, sh))


# --- one strand, one read: seed_search.cuh one_strand ------------------------

def one_strand(ix, cfg, row, drow, length):
    """(mis, pos) of one read's strand as the warp computes them; row and
    drow are lp values, zero past ``length``."""
    lp, k, st = cfg.lp, cfg.k, cfg.stride
    W, S = lp // 16, (lp - k + 1 + st - 1) // st
    row, drow = np.asarray(row, np.int64), np.asarray(drow, bool)
    if S > LANES:
        EVENTS["samples_over_lanes"] += 1
    # 1: lookups, lane l on samples s0 + l + 32u, kIlp searches together
    occ = np.zeros(S, np.int64)
    ii = np.zeros(S, np.int64)
    for s0 in range(0, S, LANES * ILP):
        s = (s0 + _LANE[None, :] + LANES * np.arange(ILP)[:, None]).ravel()
        live = s < S
        q = np.where(live, s, 0) * st
        v = np.zeros(len(s), np.int64)
        dg = np.zeros(len(s), bool)
        for j in range(k):
            v = (v << 2) | row[q + j]
            dg |= drow[q + j]
        ok = live & (q <= length - k) & ~dg
        lo = np.where(live, ix.l1[v >> ix.l1_shift], 0)
        hi = np.where(live, ix.l1[(v >> ix.l1_shift) + 1], 0)
        hi0 = hi.copy()
        for _ in range(ix.steps):
            act = lo < hi
            if not act.any():
                break
            mid = (lo + hi) >> 1
            less = ix.keys[np.minimum(mid, ix.nk - 1)] < v
            lo = np.where(act & less, mid + 1, lo)
            hi = np.where(act & ~less, mid, hi)
        i2 = np.minimum(lo, ix.nk - 1)
        found = ok & (lo < hi0) & (ix.keys[i2] == v)
        occ[s[live]] = np.where(found, ix.offsets[i2 + 1] - ix.offsets[i2],
                                BIG)[live]
        ii[s[live]] = i2[live]
    valid = np.arange(lp) < length
    sh16 = 2 * (15 - np.arange(16))
    rw = [int((np.where(valid, row, 0)[16 * w:16 * w + 16] << sh16).sum())
          for w in range(W)]
    mw = [int((np.where(valid, 3, 0)[16 * w:16 * w + 16] << sh16).sum())
          for w in range(W)]

    # 2-3: picks and candidates
    C, NS, K = cfg.n_cand, cfg.n_seeds, cfg.probe_k
    pre = K > 0 and C * NS > 2 * K and W > 3
    j1, j2 = 1, W // 2
    tot = C * NS
    pm = np.full(tot, 255, np.int64)
    cand = np.zeros(tot, np.int64)
    cnt = np.zeros(33, np.int64)
    pm_min = np.full(LANES, NONE, np.int64)
    pm_arg = np.full(LANES, NONE, np.int64)
    pm_cand = np.zeros(LANES, np.int64)
    any_valid = np.zeros(LANES, bool)
    n_surv = np.zeros(LANES, np.int64)
    cand0 = 0
    lims = []
    masked = np.zeros(S, bool)
    for it in range(NS):
        lv = np.full(LANES, NONE, np.int64)
        li = np.full(LANES, NONE, np.int64)
        for s in range(S):              # each lane over its own samples
            if occ[s] < lv[s % LANES]:
                lv[s % LANES], li[s % LANES] = occ[s], s
        ob, jb, _ = warp_argmin(lv, li)
        jb = 0 if jb == NONE else jb
        occ_best = ob if S > 0 else BIG
        pb = jb * st
        if cfg.excl_bp > 0:
            hit = np.abs(np.arange(S) * st - pb) <= cfg.excl_bp
            if (hit & masked).any():
                EVENTS["excl_overlap"] += 1
            masked |= hit
            occ[hit] = BIG
        else:
            occ[jb] = BIG
        base = max(int(ix.offsets[ii[jb]]), 0)
        lim = max(min(occ_best, C), 0)
        lims.append(lim)
        for cj0 in range(0, lim, LANES):
            cj = cj0 + _LANE
            act = cj < lim
            c = it * C + cj
            ptr = np.minimum(base + cj, ix.npos - 1)
            cp_i = ix.positions[ptr] - pb
            if it == 0 and cj0 == 0 and act[0]:
                cand0 = int(cp_i[0])
            ok = act & (cp_i >= 0) & (cp_i + length <= ix.ref_len)
            cp = cp_i & M32
            cand[c[ok]] = cp[ok]
            any_valid |= ok
            if not pre:
                pm[c[ok]] = 0
                continue
            cps = np.where(ok, cp, 0)
            p = _word_mis(ix, rw, mw, W, j1, cps)
            first = p <= cfg.max_mis
            p = np.where(first, p + _word_mis(ix, rw, mw, W, j2, cps), p + 8)
            surv = ok & first & (p <= cfg.max_mis)
            pm[c[surv]] = p[surv]
            np.add.at(cnt, p[surv], 1)
            n_surv += surv
            better = ok & (p < pm_min)
            pm_min = np.where(better, p, pm_min)
            pm_arg = np.where(better, c, pm_arg)
            pm_cand = np.where(better, cp, pm_cand)
    if not any_valid.any():
        EVENTS["cand0_fallback"] += 1
        return BIG, (cand0 if C > 0 and NS > 0 else 0)
    if not pre:
        EVENTS["prefilter_off"] += 1
    if pre and n_surv.sum() == 0:
        EVENTS["pruned_fallback"] += 1
        _, _, pc = warp_argmin(pm_min, pm_arg, pm_cand)
        return BIG, pc - ((pc >> 31) << 32)

    # 4: the verify order
    order = []
    if pre:
        start = np.concatenate([[0], np.cumsum(cnt)])[:33]
        slots = np.full(tot, -1, np.int64)
        for it in range(NS):
            for cj0 in range(0, lims[it], LANES):
                cj = cj0 + _LANE
                c = it * C + cj
                p = np.where(cj < lims[it], pm[np.minimum(c, tot - 1)], 255)
                for b in np.unique(p[p != 255]):
                    peers = np.flatnonzero(p == b)   # __match_any_sync
                    for rank, lane in enumerate(peers):
                        slots[start[b] + rank] = c[lane]
                    start[b] += len(peers)
        order = slots[:n_surv.sum()]
        assert (order >= 0).all()
    else:
        for it in range(NS):
            for cj0 in range(0, lims[it], LANES):
                c = it * C + cj0 + _LANE
                ok = (cj0 + _LANE < lims[it]) & (pm[np.minimum(c, tot - 1)]
                                                  == 0)
                order.extend(c[ok])                   # ballot compaction
        order = np.asarray(order, np.int64)
    n_list = len(order)

    # 5: verify rounds of 32, the serial rules applied in lane order
    n_eff = min(K, n_list) if pre else n_list
    best, best_pos, have = BIG, 0, False
    stop = False
    for t0 in range(0, n_eff, LANES):
        t = t0 + _LANE
        inr = t < n_eff
        c = np.where(inr, order[np.minimum(t, n_list - 1)], 0)
        p = np.where(inr & pre, pm[c], 0)
        cp = np.where(inr, cand[c], 0)
        bound = best if have else BIG
        comp = inr & ~(pre & have & (p >= bound))
        m = np.where(comp, 0, BIG)
        for j in range(0, W + 1, 4):
            live = comp & (m < bound)
            if not live.any():
                break
            for jj in range(j, min(j + 4, W + 1)):
                m = m + np.where(live, _word_mis(ix, rw, mw, W, jj, cp), 0)
        if t0 > 0 and pre and p[0] == pm[order[t0 - 1]]:
            EVENTS["tie_across_round"] += 1
        for lane in range(min(LANES, n_eff - t0)):
            if pre and have and p[lane] >= best:
                stop = True
                break
            if not have or m[lane] < best:
                best, best_pos, have = int(m[lane]), int(cp[lane]), True
                if best == 0:
                    if 0 < lane < min(LANES, n_eff - t0) - 1:
                        EVENTS["best0_mid_round"] += 1
                    stop = True
                    break
        if stop:
            break
    if pre and not stop and n_list > K:
        EVENTS["k_cut" if K % LANES else "k_cut_round_end"] += 1
    return best, best_pos - ((best_pos >> 31) << 32)


def _rc(row, drow, length):
    lp = len(row)
    i = np.arange(lp)
    src = np.clip(length - 1 - i, 0, lp - 1)
    return (np.where(i < length, 3 - np.asarray(row)[src], 0),
            np.where(i < length, np.asarray(drow)[src], False))


# --- the tiers: align_read.cuh gapless_read / strand_eval / indel_read --------

def gapless_read(ix, cfg, row, drow, length, mode, both):
    """(mapped, pos, rev, mask) of one read; mode 0 fwd, 1 rc, 2 both."""
    lp = cfg.lp
    length = min(max(int(length), 0), lp)
    has_dege = bool(np.asarray(drow)[:length].any())
    mis_f = mis_r = BIG
    pos_f = pos_r = 0
    if mode != 1:
        mis_f, pos_f = one_strand(ix, cfg, row, drow, length)
    need_rc = mode != 0 and not (mode == 2 and not both
                                 and mis_f <= cfg.max_mis)
    rc, rd = _rc(row, drow, length)
    if need_rc:
        mis_r, pos_r = one_strand(ix, cfg, rc, rd, length)
    if mode == 0:
        use_rev, mis, pos = False, mis_f, pos_f
    elif mode == 1:
        use_rev, mis, pos = mis_r <= cfg.max_mis, mis_r, pos_r
    else:
        use_rev = mis_r < mis_f if both else mis_f > cfg.max_mis
        mis, pos = (mis_r, pos_r) if use_rev else (mis_f, pos_f)
    mapped = mis <= cfg.max_mis and not has_dege and length >= cfg.k
    eff = rc if (mode == 1 or (mode == 2 and use_rev)) else np.asarray(row)
    i = np.arange(lp)
    mm = (mapped & (i < length)
          & (eff != ix.base((pos & M32) + i)))
    return mapped, pos, use_rev and mapped, mm


def strand_eval(ix, cfg, c, d, length, G, ops):
    """(SRes dict, rows E (2G+2, lp+1)) of one strand, the rows filled 32
    columns at a time with a carry and every split a warp argmin."""
    lp, NG = cfg.lp, 2 * G + 1
    _, posi = one_strand(ix, cfg, c, d, length)
    ok_b = posi >= 2 * G and posi + length + 2 * G <= ix.ref_len
    c = np.asarray(c, np.int64)
    E = np.zeros((NG + 1, lp + 1), np.int64)
    for j in range(NG + 1):
        carry = 0
        for i0 in range(0, lp, LANES):
            i = i0 + _LANE
            x = np.zeros(LANES, np.int64)
            live = i < length
            ic = np.minimum(i, lp - 1)
            if j < NG:
                idx = np.clip(posi + (j - G) + i, 0, ix.ref_len - 1)
                x = np.where(live, c[ic] != ix.base(idx), 0)
            else:
                x = np.where(live, c[ic] != 0, 0)
            incl = np.cumsum(x)                     # warp_scan
            E[j, np.minimum(i, lp - 1) + 1] = np.where(i < lp, carry + incl,
                                                       E[j, ic + 1])
            carry += int(incl[-1])
    F, E0 = E[NG], E[G]
    b = dict(tot=BIG, sA=0, gA=0, sB=0, gB=0, po=posi, jb=0, pg=0, sg=0)

    def consider(pref, suf, h, g_out, d_pos, pg, sg, variant):
        sl = suf[length]
        tb, sb = range_argmin(0, length - h, lambda s: pref[s]
                              + (F[s + h] - F[s]) + (sl - suf[s + h]))
        if variant == "B" and tb == b["tot"] and tb < BIG:
            EVENTS["indel_tie_A_B"] += 1
        if tb < b["tot"]:
            b.update(tot=tb, sA=sb, gA=g_out, po=posi + d_pos, pg=pg + G,
                     sg=sg + G, jb=pg + G)

    for g in range(-G, G + 1):
        if g == 0:
            continue
        Eg, h = E[g + G], abs(g)
        if g > 0:
            consider(E0, Eg, 0, g, 0, 0, g, "A")
            consider(Eg, E0, h, -g, g, g, 0, "B")
        else:
            consider(E0, Eg, h, g, 0, 0, g, "A")
            consider(Eg, E0, 0, -g, g, g, 0, "B")
    if not ok_b:
        b["tot"] = BIG
    if ops >= 2 and cfg.max_mis < b["tot"] < BIG:
        EVENTS["second_op"] += 1
        h1 = -b["gA"] if b["gA"] < 0 else 0
        s1 = b["sA"]
        Epg, Esg = E[b["pg"]], E[b["sg"]]
        op1_lit = F[s1 + h1] - F[s1]
        base_c = Epg[s1] + op1_lit - Esg[s1 + h1]
        tt, st, gt = BIG, 0, 0
        for g2 in range(-G, G + 1):
            j2 = b["sg"] + g2
            if g2 == 0 or not 0 <= j2 <= 2 * G:
                continue
            E2, h2 = E[j2], (-g2 if g2 < 0 else 0)
            e2l = E2[length]
            tb, sb = range_argmin(s1 + h1, length - h2, lambda s: base_c
                                  + Esg[s] + (F[s + h2] - F[s])
                                  + (e2l - E2[s + h2]))
            if tb < tt:
                tt, st, gt = tb, sb, g2
        tail_c = op1_lit + Esg[length] - Esg[s1 + h1] + Epg[s1]
        th_, sh, gh_sel = BIG, 0, 0
        for gh in range(-G, G + 1):
            j0 = b["pg"] + gh
            if gh == 0 or not 0 <= j0 <= 2 * G:
                continue
            Ej0, hh = E[j0], (gh if gh > 0 else 0)
            tb, sb = range_argmin(0, s1 - hh, lambda s: tail_c + Ej0[s]
                                  + (F[s + hh] - F[s]) - Epg[s + hh])
            if tb < th_:
                th_, sh, gh_sel = tb, sb, gh
        use_head = th_ < tt
        tbest = th_ if use_head else tt
        if tbest < b["tot"]:
            b["tot"] = tbest
            if use_head:
                b.update(sB=b["sA"], gB=b["gA"], sA=sh, gA=-gh_sel,
                         jb=b["pg"] + gh_sel, po=b["po"] + gh_sel)
            else:
                b.update(sB=st, gB=gt)
    return b, E


def indel_read(ix, cfg, row, drow, length, G, ops):
    """(found, pos, s1, g1, s2, g2, rev, mask) of one read."""
    lp = cfg.lp
    length = min(max(int(length), 0), lp)
    has_dege = bool(np.asarray(drow)[:length].any())
    f, Ef = strand_eval(ix, cfg, row, drow, length, G, ops)
    rv, Er = dict(tot=BIG), None
    if f["tot"] > 0:
        rc, rd = _rc(row, drow, length)
        rv, Er = strand_eval(ix, cfg, rc, rd, length, G, ops)
    use_rev = rv["tot"] < f["tot"]
    r, E = (rv, Er) if use_rev else (f, Ef)
    found = r["tot"] <= cfg.max_mis and not has_dege and length >= cfg.k
    hA = -r["gA"] if r["gA"] < 0 else 0
    hB = -r["gB"] if r["gB"] < 0 else 0

    def row_at(j):
        return E[min(max(j, 0), 2 * G)]
    r0, r1 = row_at(r["jb"]), row_at(r["jb"] + r["gA"])
    r2, F = row_at(r["jb"] + r["gA"] + r["gB"]), E[2 * G + 1]
    mm = np.zeros(lp, bool)
    for i in range(length if found else 0):
        if i < r["sA"]:
            rr = r0
        elif i < r["sA"] + hA:
            rr = F if hA > 0 else r1
        elif i < r["sB"]:
            rr = r1
        elif i < r["sB"] + hB:
            rr = F if hB > 0 else r2
        else:
            rr = r2
        mm[i] = rr[i + 1] - rr[i]
    return (found, r["po"], r["sA"], r["gA"], r["sB"], r["gB"],
            use_rev and found, mm)


_MODE = {"fwd": 0, "rc": 1, "both": 2}


def align_batch(ix, cfg, codes, dege, lengths):
    outs = [gapless_read(ix, cfg, codes[b], dege[b], lengths[b],
                         _MODE[cfg.strand], cfg.both_strands)
            for b in range(len(lengths))]
    return [np.array([o[i] for o in outs]) for i in range(4)]


def indel_batch(ix, cfg, codes, dege, lengths, G, ops):
    outs = [indel_read(ix, cfg, codes[b], dege[b], lengths[b], G, ops)
            for b in range(len(lengths))]
    return [np.array([o[i] for o in outs]) for i in range(8)]


def rescue_indel_fused(ix, codes, dege, lengths, idx, do, cfg2, cfg3, G,
                       ops):
    """rescue_indel_fused.cu a slot at a time (one warp each)."""
    cap, lp = len(idx), cfg3.lp
    out = [np.zeros(cap, bool), np.zeros(cap, np.int64), np.zeros(cap, bool),
           np.zeros((cap, lp), bool), np.zeros(cap, bool)] + [
        np.zeros(cap, np.int64) for _ in range(5)] + [
        np.zeros(cap, bool), np.zeros((cap, lp), bool)]
    for i in range(cap):
        r = min(max(int(idx[i]), 0), len(lengths) - 1)
        hit = False
        if cfg2 is not None and do[i]:
            res = gapless_read(ix, cfg2, codes[r], dege[r], lengths[r], 2,
                               cfg2.both_strands)
            for j in range(4):
                out[j][i] = res[j]
            hit = res[0]
        if ops > 0 and do[i] and not hit:
            res = indel_read(ix, cfg3, codes[r], dege[r], lengths[r], G, ops)
            for j in range(8):
                out[4 + j][i] = res[j]
    return out


# --- fixtures ------------------------------------------------------------------

_REPEAT_AT, _REPEATS, _UNIT = 12_000, 80, 100
_VAR_AT = 40      # outside both probe words for any phase


def _reference(rng):
    """A 40 kbp reference: random, with 80 copies of a 100 bp unit, each
    carrying a non-A base at unit position 40 but copy 45 (an A there)."""
    ref = rng.integers(0, 4, 40_000).astype(np.uint8)
    unit = rng.integers(0, 4, _UNIT).astype(np.uint8)
    unit[_VAR_AT] = 0
    for j in range(_REPEATS):
        u = unit.copy()
        u[_VAR_AT] = 0 if j == 45 else 1 + j % 3
        at = _REPEAT_AT + j * (_UNIT + 37)
        ref[at:at + _UNIT] = u
    return ref, unit


def _reads(rng, ref, unit, n, long=False):
    """Reads of every kind: clean, substitutions, a deletion, an insertion,
    two indels, random (every candidate pruned), shorter than k, wrapping
    the reference's end (no valid candidate), and the repeat unit with an
    N at the variable base (every valid seed lists all 80 copies: ties in
    the verify order past 32 entries, copy 45 the only exact one); ~40%
    reverse strand.  ``long``: 700-1,000 bp reads, clean, with 5
    substitutions, a deletion or an insertion."""
    reads, dege = [], []
    for i in range(n):
        kind = (0, 1, 0, 2, 3)[i % 5] if long else i % 9
        L = int(rng.integers(700, 1000) if long else rng.integers(70, 110))
        s = int(rng.integers(100, len(ref) - L - 200))
        r = ref[s:s + L + 6].copy()
        d = None
        if kind == 1:
            at = rng.integers(0, L, 5 if long else 9)
            r[at] = (r[at] + rng.integers(1, 4, len(at))) % 4
        elif kind == 2:
            g, at = int(rng.integers(1, 4)), int(rng.integers(20, L - 20))
            r = np.concatenate([r[:at], r[at + g:]])
        elif kind == 3:
            g, at = int(rng.integers(1, 4)), int(rng.integers(20, L - 20))
            r = np.concatenate([r[:at], rng.integers(0, 4, g)
                                .astype(np.uint8), r[at:]])
        elif kind == 4:
            a, b = int(rng.integers(15, 30)), int(rng.integers(55, 75))
            r = np.concatenate([r[:a], r[a + 2:b], rng.integers(0, 4, 1)
                                .astype(np.uint8), r[b:]])
        elif kind == 5:
            r = rng.integers(0, 4, L).astype(np.uint8)
        elif kind == 6:
            L = int(rng.integers(5, 14))
        elif kind == 7:
            r = np.concatenate([ref[-50:], ref[:60]])
            L = len(r)
        elif kind == 8:
            r, L = unit.copy(), _UNIT
            d = np.zeros(L, bool)
            d[_VAR_AT] = True
        r = r[:L]
        if kind not in (7, 8) and rng.random() < 0.4:
            r = (3 - r)[::-1].copy()
        reads.append(r)
        dege.append(np.zeros(L, bool) if d is None else d)
    lengths = np.array([len(r) for r in reads], np.int64)
    return np.concatenate(reads), np.concatenate(dege), lengths


@pytest.fixture(scope="module")
def warp_fixture():
    """{k: (JAX aligner, port aligner, Ix)} over the repeat reference, and
    the read grids at Lp 128 (96 reads) and Lp 1024 (10 long reads)."""
    rng = np.random.default_rng(1101)
    ref, unit = _reference(rng)
    from fastqueeze_tpu.align.ref import RefSeq as JRef
    from fastqueeze_tpu_torch.align.ref import RefSeq
    out = {}
    for k in (14, 22):
        jal = jh.Aligner(jidx.build_from_ref(
            JRef(ref, np.zeros(len(ref), bool), ["r"],
                 np.array([0, len(ref)]), ""), JParams(seed_len=k)),
            JParams(seed_len=k))
        tal = th.Aligner(tidx.build_from_ref(
            RefSeq(ref, np.zeros(len(ref), bool), ["r"],
                   np.array([0, len(ref)]), ""), CodecParams(seed_len=k)),
            CodecParams(seed_len=k))
        out[k] = (jal, tal, Ix(tal))
    for lp, n, long in ((128, 96, False), (1024, 10, True)):
        cf, df, ln = _reads(rng, ref, unit, n, long)
        cg, dg = th._gridify(cf, df, ln, lp)
        out[lp] = (cg.astype(np.int64), dg, ln)
    return out


def _cfgs(k, jal, lp, **kw):
    base = dict(k=k, stride=2, n_cand=64, max_mis=7, both_strands=0, lp=lp)
    base.update(kw)
    jcfg = jh.AlignConfig(l1_shift=jal._l1_shift,
                          search_steps=jal._search_steps, wide=k > 15,
                          **base)
    return jcfg, th.AlignConfig(**base)


def _jax_args(jal, cg, dg, ln):
    return (*jal._dev_arrays(), jnp.int32(jal.ref_len),
            jnp.asarray(cg.astype(np.uint8)), jnp.asarray(dg),
            jnp.asarray(ln.astype(np.int32)))


def _torch(cg, dg, ln):
    return (torch.from_numpy(cg.astype(np.uint8)), torch.from_numpy(dg),
            torch.from_numpy(ln.astype(np.int32)))


_ONE_STRAND = {
    # tier 1 at the CLI defaults: 64 candidates, the top 16 verify
    "tier1": dict(probe_k=16),
    # 64 candidates <= 2K: no prefilter, index order
    "no_prefilter": dict(probe_k=32),
    # the rescue tier: 6 picks of up to 1,024 candidates, +-7 bp masks
    "rescue": dict(n_cand=1024, n_seeds=6, excl_bp=7, probe_k=1024),
    # the repeat unit's 80 tied survivors: only the first 40 verify
    "rescue_K40": dict(n_cand=1024, n_seeds=6, excl_bp=7, probe_k=40),
    # +-20 bp masks: every pick's mask overlaps the one before
    "wide_masks": dict(n_cand=256, n_seeds=4, excl_bp=20, probe_k=64),
}


@pytest.mark.parametrize("k", [14, 22])
@pytest.mark.parametrize("name", sorted(_ONE_STRAND))
def test_one_strand_mirror_matches_jax_and_plain(warp_fixture, k, name):
    """The warp mirror's (mis, pos) on both strands of every read equal
    the port's plain _one_strand everywhere and the JAX _one_strand's on
    every read but the pruned fallbacks (which JAX ranks by the two-word
    probe count, the port as the native mirror does)."""
    jal, tal, ix = warp_fixture[k]
    cg, dg, ln = warp_fixture[128]
    jcfg, cfg = _cfgs(k, jal, 128, **_ONE_STRAND[name])
    rc, rd = kernels._rc_grid(*_torch(cg, dg, ln)[:2],
                              torch.from_numpy(ln))
    one = jax.jit(jh._one_strand, static_argnums=0)
    for c, d in ((cg, dg), (rc.numpy(), rd.numpy())):
        got = np.array([one_strand(ix, cfg, c[b], d[b], ln[b])
                        for b in range(len(ln))])
        tc, td, tl = _torch(c, d, ln)
        mis, pos = kernels._one_strand_plain(cfg, tal.dev_index("cpu"), tc,
                                             td, tl.long())
        assert np.array_equal(got[:, 0], mis.numpy())
        assert np.array_equal(got[:, 1], pos.numpy())
        jmis, jpos = (np.asarray(x) for x in one(jcfg, *_jax_args(
            jal, c, d, ln)))
        assert np.array_equal(got[:, 0], jmis)
        mapped = got[:, 0] < BIG
        assert mapped.sum() > 10
        assert np.array_equal(got[mapped, 1],
                              jpos[mapped].astype(np.int32))


_K8 = {
    "fwd": dict(strand="fwd", probe_k=16),
    "rc": dict(strand="rc", probe_k=16),
    "both_strands": dict(both_strands=1, probe_k=16),
    "rc_fallback": dict(probe_k=16),
    "rescue": dict(n_cand=1024, n_seeds=6, excl_bp=7),
}


@pytest.mark.parametrize("k", [14, 22])
@pytest.mark.parametrize("name", sorted(_K8))
def test_gapless_mirror_matches_jax_and_plain(warp_fixture, k, name):
    """K8's warp decomposition (gapless_read) against align_batch_plain on
    every output of every read and the JAX _align_batch on the mapped."""
    jal, tal, ix = warp_fixture[k]
    cg, dg, ln = warp_fixture[128]
    jcfg, cfg = _cfgs(k, jal, 128, **_K8[name])
    got = align_batch(ix, cfg, cg, dg, ln)
    want = [x.numpy() for x in kernels.align_batch_plain(
        *_torch(cg, dg, ln), tal.dev_index("cpu"), cfg)]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    m = got[0]
    assert m.sum() > 2
    jw = [np.asarray(x) for x in jh._align_batch(jcfg,
                                                 *_jax_args(jal, cg, dg, ln))]
    assert np.array_equal(jw[0], m) and np.array_equal(jw[2], got[2])
    assert np.array_equal(jw[1][m], got[1][m])
    assert np.array_equal(jw[3], got[3])


@pytest.mark.parametrize("k", [14, 22])
@pytest.mark.parametrize("G,ops", [(3, 2), (1, 1)])
def test_indel_mirror_matches_jax_and_plain(warp_fixture, k, G, ops):
    """K9's warp decomposition (indel_read) against indel_batch_plain on
    found and on every found read's outputs, the anchors of every read,
    and the JAX _indel_batch on the found reads whose anchors agree."""
    jal, tal, ix = warp_fixture[k]
    cg, dg, ln = warp_fixture[128]
    jcfg, cfg = _cfgs(k, jal, 128, n_cand=1024, n_seeds=6, excl_bp=7)
    got = indel_batch(ix, cfg, cg, dg, ln, G, ops)
    want = [x.numpy() for x in kernels.indel_batch_plain(
        *_torch(cg, dg, ln), tal.dev_index("cpu"), cfg, G, ops)]
    f = got[0]
    assert np.array_equal(f, want[0]) and f.sum() > 10
    assert np.array_equal(got[1], want[1])
    for a, b in zip(got[2:], want[2:]):
        assert np.array_equal(a[f], b[f])
    if ops == 2:
        assert (got[5][f] != 0).any()
    jw = [np.asarray(x) for x in jh._indel_batch(jcfg, G, ops, *_jax_args(
        jal, cg, dg, ln))]
    agree = jw[1] == got[1]
    assert (f & agree).sum() > 10
    fa = f & agree
    assert np.array_equal(jw[0][agree], f[agree])
    for a, b in zip(got[1:], jw[1:]):
        assert np.array_equal(a[fa], b[fa].astype(a.dtype))


@pytest.mark.parametrize("variant", ["rescue", "indel", "both"])
def test_fused_mirror_matches_jax_and_plain(warp_fixture, variant):
    """K14 a slot a warp: a shuffled todo list of 64 slots, a tenth off
    and 16 padding slots, against rescue_indel_fused_plain and the JAX
    _rescue_indel_fused (k = 22, G = 3, two ops), its indel half on the
    slots whose anchors agree (see test_indel_mirror_matches_jax_and_plain)."""
    jal, tal, ix = warp_fixture[22]
    cg, dg, ln = warp_fixture[128]
    rng = np.random.default_rng(9)
    cap = 64
    idx = rng.integers(0, len(ln), cap).astype(np.int32)
    do = np.arange(cap) < 48
    do[rng.integers(0, 48, 5)] = False
    G, ops = (0, 0) if variant == "rescue" else (3, 2)
    jcfg, cfg = _cfgs(22, jal, 128, n_cand=1024, n_seeds=6, excl_bp=7)
    rescue = variant != "indel"
    got = rescue_indel_fused(ix, cg, dg, ln, idx, do,
                             cfg if rescue else None, cfg, G, ops)
    want = [x.numpy() for x in kernels.rescue_indel_fused_plain(
        *_torch(cg, dg, ln), torch.from_numpy(idx), torch.from_numpy(do),
        tal.dev_index("cpu"), cfg if rescue else None, cfg, G, ops)]
    jw = [np.asarray(x) for x in jh._rescue_indel_fused(
        jcfg if rescue else None, jcfg, G, ops, *_jax_args(jal, cg, dg, ln),
        jnp.asarray(idx), jnp.asarray(do))]
    m2, f = got[0], got[4]
    assert np.array_equal(m2, want[0]) and np.array_equal(f, want[4])
    assert np.array_equal(m2, jw[0])
    assert not (m2 | f)[~do].any() and (m2.sum() if rescue else f.sum()) > 2
    agree = jw[5] == got[5]
    assert np.array_equal(f[agree], jw[4][agree])
    for sel, lo, hi in ((m2, 1, 4), (f, 5, 12)):
        for a, b in zip(got[lo:hi], want[lo:hi]):
            assert np.array_equal(a[sel], b[sel].astype(a.dtype))
        jsel = sel & agree if lo == 5 else sel
        for a, b in zip(got[lo:hi], jw[lo:hi]):
            assert np.array_equal(a[jsel], b[jsel].astype(a.dtype))


@pytest.mark.parametrize("tier", ["tier1_both", "rescue", "indel"])
def test_lp1024_mirror_matches_plain(warp_fixture, tier):
    """The chunk tier's grid, Lp 1024: 494 samples a strand (more than a
    lane's kIlp groups), K8 both strands and rescue, K9 (G = 3, two ops),
    against the plain versions; K8 also against the JAX _align_batch."""
    jal, tal, ix = warp_fixture[14]
    cg, dg, ln = warp_fixture[1024]
    kw = (dict(both_strands=1, probe_k=16) if tier == "tier1_both"
          else dict(n_cand=1024, n_seeds=6, excl_bp=7))
    jcfg, cfg = _cfgs(14, jal, 1024, **kw)
    args = (*_torch(cg, dg, ln), tal.dev_index("cpu"), cfg)
    if tier == "indel":
        got = indel_batch(ix, cfg, cg, dg, ln, 3, 2)
        want = [x.numpy() for x in kernels.indel_batch_plain(*args, 3, 2)]
        f = got[0]
        assert np.array_equal(f, want[0]) and f.sum() >= 5
        assert np.array_equal(got[1], want[1])
        for a, b in zip(got[2:], want[2:]):
            assert np.array_equal(a[f], b[f])
        return
    got = align_batch(ix, cfg, cg, dg, ln)
    want = [x.numpy() for x in kernels.align_batch_plain(*args)]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    m = got[0]
    assert m.sum() >= 5
    jw = [np.asarray(x) for x in jh._align_batch(jcfg,
                                                 *_jax_args(jal, cg, dg, ln))]
    assert np.array_equal(jw[0], m) and np.array_equal(jw[1][m], got[1][m])


def test_every_rule_fired(warp_fixture):
    """Each rule the warp decomposition splits fires on these reads: the
    mirror alone over the forward reads at the configurations of the
    tests above (k = 14), the indel tier on the indel reads, and one
    Lp 1024 read."""
    jal, tal, ix = warp_fixture[14]
    cg, dg, ln = warp_fixture[128]
    EVENTS.clear()
    for name in ("tier1", "no_prefilter", "rescue", "rescue_K40",
                 "wide_masks"):
        _, cfg = _cfgs(14, jal, 128, **_ONE_STRAND[name])
        for b in range(len(ln)):
            one_strand(ix, cfg, cg[b], dg[b], ln[b])
    _, cfg = _cfgs(14, jal, 128, n_cand=1024, n_seeds=6, excl_bp=7)
    for b in range(2, len(ln), 9):          # the indel kinds 2-4
        for r in (b, b + 1, b + 2):
            indel_read(ix, cfg, cg[r], dg[r], ln[r], 3, 2)
    lg, ld, ll = warp_fixture[1024]
    _, cfg = _cfgs(14, jal, 1024, probe_k=16)
    one_strand(ix, cfg, lg[0], ld[0], ll[0])
    want = ("prefilter_off", "cand0_fallback", "pruned_fallback",
            "tie_across_round", "k_cut", "best0_mid_round", "excl_overlap",
            "samples_over_lanes", "indel_tie_A_B", "second_op")
    missing = [w for w in want if EVENTS[w] == 0]
    assert not missing, (missing, dict(EVENTS))
