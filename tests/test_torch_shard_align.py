"""K19's warp design, mirrored lane by lane, and its plain phases held to
fastqueeze_tpu's index-sharded aligner.

The mirrors follow csrc/sharded_align.cu's decomposition with numpy on a
few reads: the read's effective strand packed into 16-base words and
32-base degenerate bit words by lanes (the two __reduce_or_sync and the
ballot of each 32 bases), each seed's k-mer cut from the words by one
64-bit funnel and its window's degenerate bits by one mask, the binary
search skipped for invalid seeds; each candidates round's first-index
argmin as two warp reductions (count, then seed) and the +-excl_bp mask;
the verify's frame words built once a read by residue class mod 16 with
the folded mask, a lane a candidate in rounds of 32, and the two
reductions of the argmin.  Each mirror equals the phase's plain version
in kernels.py on every output.  The cases are the ones the kernel
branches on: Lp 128, 144 (a half chunk of 32 bases) and 1024 (kMaxW, the
frame words in shared memory), narrow and wide keys (k = 11, 14, 22,
31), strides 1-3, one and several seeds with and without the exclusion
window, n_seeds x C not divisible by D (padding columns), reads shorter
than k and reads with degenerate bases, both strands.  The plain phases
through parallel/mesh.align_blocks_index_sharded on CPU shards then equal
fastqueeze_tpu.parallel.mesh.align_blocks_index_sharded (its 8 virtual
devices) in mapped, pos, rev and mask.  Every output is an integer, so
every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.align import index as jidx
from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.parallel import mesh as jm
from fastqueeze_tpu_torch.align import index as tidx
from fastqueeze_tpu_torch.align.hash import _gridify
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.ops import kernels
from fastqueeze_tpu_torch.parallel import mesh as tm

CPU = torch.device("cpu")
BIG = kernels.ALIGN_BIG
M32 = 0xFFFFFFFF
D = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(n: int = 24_000, seed: int = 5):
    """A seeded reference with a repeat family (deep candidate lists)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n).astype(np.uint8)
    for j in range(30):
        ref[6000 + j * 90:6000 + j * 90 + 70] = ref[:70]
    return ref


def _reads(ref, R: int, lens, k: int, seed: int):
    """R reads of lens[0]..lens[1] bases: ~1% substitutions, every third
    reverse complemented, every seventh random, two shorter than k, two
    with a degenerate base, one from the repeats."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(R):
        n = int(rng.integers(*lens))
        if i in (3, 11):
            n = int(rng.integers(1, k))
        s = 6000 + 90 * int(rng.integers(0, 30)) if i == 5 else int(
            rng.integers(0, len(ref) - n))
        r = ref[s:s + n].copy()
        e = rng.random(n) < 0.01
        r[e] = (r[e] + 1) % 4
        if i % 7 == 6:
            r = rng.integers(0, 4, n).astype(np.uint8)
        if i % 3 == 0:
            r = (3 - r)[::-1].copy()
        out.append(r)
    lengths = np.array([len(r) for r in out], np.int64)
    codes = np.concatenate(out)
    dege = np.zeros(len(codes), bool)
    for i in (4, 9):
        dege[int(lengths[:i].sum()) + int(lengths[i]) // 2] = True
    return codes, dege, lengths


def _shards(ref, k: int):
    n = len(ref)
    tref = tidx.RefSeq(ref, np.zeros(n, bool), ["t"], np.array([0, n]), "x")
    idx = tidx.build_from_ref(tref, CodecParams(seed_len=k))
    sh = tm.shard_ref_index(idx, D)
    steps = max(1, int(np.ceil(np.log2(sh["kp"] + 1))))
    i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a).view(np.int32))
    sxs = [kernels.ShardIndex(i32(sh["keys_hi"][c]), i32(sh["keys_lo"][c]),
                              i32(sh["offsets"][c]), i32(sh["positions"][c]),
                              i32(sh["packed"]), sh["ref_len"], sh["k"],
                              steps)
           for c in range(D)]
    return idx, sh, sxs


# --- the warp's steps in numpy ------------------------------------------------

def _eff(row, drow, Lp, ln, rc):
    """The effective strand's codes and degenerate flags (kernel eff_code,
    eff_dege)."""
    i = np.arange(Lp)
    if not rc:
        return row.astype(np.int64), drow.astype(bool)
    j = np.clip(ln - 1 - i, 0, Lp - 1)
    return (np.where(i < ln, 3 - row[j].astype(np.int64), 0),
            (i < ln) & drow[j].astype(bool))


def _read_words(row, drow, Lp, ln, rc):
    """read_words: per 32-base chunk i0, lane l on base i0 + l; lanes 0-15
    OR c << 2 (15 - l) into word i0 / 16, lanes 16-31 c << 2 (31 - l) into
    word i0 / 16 + 1, a ballot of the flags into bit word i0 / 32; two
    zero words past the row."""
    W = Lp // 16
    c, d = _eff(row, drow, Lp, ln, rc)
    cw = np.zeros(W + 3, np.uint64)
    dw = np.zeros(Lp // 32 + 3, np.uint64)
    for i0 in range(0, Lp, 32):
        a = b = bal = 0
        for lane in range(32):
            i = i0 + lane
            ci = int(c[i]) if i < Lp else 0
            if lane < 16:
                a |= ci << (2 * (15 - lane))
            else:
                b |= ci << (2 * (31 - lane))
            if i < Lp and d[i]:
                bal |= 1 << lane
        cw[i0 // 16], cw[i0 // 16 + 1], dw[i0 // 32] = a, b, bal
    cw[W] = cw[W + 1] = 0
    dw[(Lp + 31) // 32] = dw[(Lp + 31) // 32 + 1] = 0
    return [int(x) for x in cw], [int(x) for x in dw]


def _lookup_mirror(row, drow, Lp, ln, rc, sx, stride, S):
    k, wide = sx.k, sx.k > 15
    cw, dw = _read_words(row, drow, Lp, ln, rc)
    kh = sx.keys_hi.numpy().view(np.uint32).astype(np.int64)
    kl = sx.keys_lo.numpy().view(np.uint32).astype(np.int64)
    offs = sx.offsets.numpy().astype(np.int64)
    nk = len(kh)
    occ, found, ii = [], [], []
    for s in range(S):
        q = s * stride
        wi, o = q >> 4, q & 15
        w2 = (cw[wi] << 32) | cw[wi + 1]
        x = ((w2 << (2 * o)) | (cw[wi + 2] >> (32 - 2 * o))) if o else w2
        v = (x & ((1 << 64) - 1)) >> (64 - 2 * k)
        di, db = q >> 5, q & 31
        dg = (((dw[di + 1] << 32) | dw[di]) >> db) & ((1 << k) - 1)
        ok = q <= ln - k and dg == 0
        qh = (v >> 30) if wide else v
        ql = v & 0x3FFFFFFF
        lo, hi = 0, (nk if ok else 0)
        for _ in range(sx.steps):
            if lo < hi:
                mid = (lo + hi) >> 1
                m = min(mid, nk - 1)
                less = kh[m] < qh or (wide and kh[m] == qh and kl[m] < ql)
                lo, hi = (mid + 1, hi) if less else (lo, mid)
        f = False
        if ok:
            i2 = min(lo, nk - 1)
            f = kh[i2] == qh and (not wide or kl[i2] == ql) and lo < nk
        occ.append(offs[i2 + 1] - offs[i2] if f else BIG)
        found.append(f)
        ii.append(i2 if f else 0)
    return occ, found, ii


def _warp_argmin(vals):
    """Lane l keeps the first strict minimum of vals[l::32]; the warp's
    minimum, then the least index among the lanes holding it."""
    best = [(M32, M32)] * 32
    for i, v in enumerate(vals):
        if v < best[i % 32][0]:
            best[i % 32] = (v, i)
    g = min(b[0] for b in best)
    return g, min(b[1] for b in best if b[0] == g)


def _candidates_mirror(occ, found, ii, sx, stride, n_seeds, C, excl_bp):
    o = list(occ)
    S = len(o)
    offs = sx.offsets.numpy().astype(np.int64)
    posv = sx.positions.numpy().view(np.uint32).astype(np.int64)
    cand, inr, owner = [], [], []
    for _ in range(n_seeds):
        g, jb = _warp_argmin(o)
        pb = jb * stride
        for s in range(S):
            if (abs(s * stride - pb) <= excl_bp) if excl_bp > 0 else s == jb:
                o[s] = BIG
        own = bool(found[jb])
        base = offs[ii[jb]] if own else 0
        for j in range(C):
            p = min(max(base + j, 0), len(posv) - 1)
            cand.append((posv[p] - pb) & M32 if own else 0)
            inr.append(j < min(g, C))
        owner.append(own)
    return cand, inr, owner


def _frame(words, j, W, sh):
    lo = words[j] if j < W else 0
    hi = words[j - 1] if 1 <= j <= W else 0
    return (((hi << 32) | lo) >> sh) & M32


def _verify_mirror(row, Lp, ln, rc, cand, inr, owner, C, ref_len, c0, Cs,
                   packed):
    W = Lp // 16
    cw, _ = _read_words(row, np.zeros(Lp, bool), Lp, ln, rc)
    mw = []
    for w in range(W):
        nv = min(max(ln - 16 * w, 0), 16)
        mw.append(M32 if nv == 16 else (0 if nv == 0 else
                                        (~(M32 >> (2 * nv))) & M32))
    rw = [cw[w] & mw[w] for w in range(W)]
    F = [[_frame(rw, j, W, 2 * r) for j in range(W + 1)] for r in range(16)]
    M = [[_frame(mw, j, W, 2 * r) & 0x55555555 for j in range(W + 1)]
         for r in range(16)]
    nw = len(packed)
    stot = len(cand)
    fits = ln <= ref_len
    max_start = (ref_len - ln) & M32
    mis, cvs = [], []
    for c in range(Cs):
        col = c0 + c
        cv, ok = 0, False
        if col < stot:
            cv = cand[col]
            ok = inr[col] and owner[col // C] and fits and cv <= max_start
        m = BIG
        if ok:
            r, w0 = cv & 15, cv >> 4
            m = 0
            for j in range(W + 1):
                x = F[r][j] ^ packed[min(max(w0 + j, 0), nw - 1)]
                m += bin((x | (x >> 1)) & M[r][j]).count("1")
        mis.append(m)
        cvs.append(cv)
    g, cb = _warp_argmin(mis)
    return g, cvs[cb]


_CASES = {
    "lp128_k14_s2_six_seeds": dict(Lp=128, k=14, stride=2, n_seeds=6, C=64,
                                   excl_bp=7, lens=(60, 128)),
    "lp144_k11_s1_padding": dict(Lp=144, k=11, stride=1, n_seeds=3, C=5,
                                 excl_bp=0, lens=(80, 144)),
    "lp1024_k22_s2_wide": dict(Lp=1024, k=22, stride=2, n_seeds=2, C=16,
                               excl_bp=4, lens=(300, 1024)),
    "lp128_k31_s3_one_seed": dict(Lp=128, k=31, stride=3, n_seeds=1, C=8,
                                  excl_bp=0, lens=(40, 128)),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_warp_phases_mirror_plain(name):
    """Each phase's warp decomposition, mirrored lane by lane on 16 reads
    of both strands, == the phase's plain version over the D = 4 shards
    (lookup, candidates, verify of each shard's slice; the tail is the
    plain version's, through the JAX comparison below)."""
    cs = _CASES[name]
    Lp, k, stride = cs["Lp"], cs["k"], cs["stride"]
    ref = _ref()
    _, sh, sxs = _shards(ref, k)
    codes, dege, lengths = _reads(ref, 16, cs["lens"], k, seed=len(name))
    c, d = _gridify(codes, dege, lengths, Lp)
    ct, dt = torch.from_numpy(c), torch.from_numpy(d)
    ln = torch.from_numpy(lengths.astype(np.int32))
    S = kernels.n_seed_samples(Lp, k, stride)
    C, n_seeds = cs["C"], cs["n_seeds"]
    Cs = -(-(n_seeds * C) // D)
    packed = [int(x) for x in sh["packed"]]
    for rc in (False, True):
        look = [kernels.sharded_lookup_plain(ct, dt, ln, sx, stride, rc)
                for sx in sxs]
        for b in range(len(lengths)):
            for sx, (o, f, i) in zip(sxs, look):
                mo, mf, mi = _lookup_mirror(c[b], d[b], Lp, int(lengths[b]),
                                            rc, sx, stride, S)
                assert o[b].tolist() == mo and f[b].tolist() == mf
                assert i[b].tolist() == mi
        occ = tm.pmin([x[0] for x in look])
        cands = [kernels.sharded_candidates_plain(
            occ[s], look[s][1], look[s][2], sxs[s], stride, n_seeds, C,
            cs["excl_bp"]) for s in range(D)]
        for b in range(len(lengths)):
            for s in range(D):
                mc, mr, mo = _candidates_mirror(
                    occ[s][b].tolist(), look[s][1][b].tolist(),
                    look[s][2][b].tolist(), sxs[s], stride, n_seeds, C,
                    cs["excl_bp"])
                got = cands[s]
                assert (got[0][b].numpy().view(np.uint32).tolist() == mc)
                assert got[1][b].tolist() == mr and got[2][b].tolist() == mo
        cand = tm.pmax([x[0] for x in cands], unsigned=True)[0]
        owner = tm.pmax([x[2].to(torch.int32) for x in cands])[0] > 0
        inr = cands[0][1]
        for s in range(D):
            mis, pos = kernels.sharded_verify_plain(
                ct, ln, cand, inr, owner, C, sh["ref_len"], s * Cs, Cs,
                sxs[s].packed, rc)
            for b in range(len(lengths)):
                g, p = _verify_mirror(
                    c[b], Lp, int(lengths[b]), rc,
                    cand[b].numpy().view(np.uint32).tolist(),
                    inr[b].tolist(), owner[b].tolist(), C, sh["ref_len"],
                    s * Cs, Cs, packed)
                assert (int(mis[b]), int(pos[b]) & M32) == (g, p), (rc, s, b)


_JAX_CASES = {
    "lp1024_k14": dict(Lp=1024, k=14, lens=(300, 1024), max_mis=40, kw={}),
    "lp128_k22_padding_both": dict(
        Lp=128, k=22, lens=(50, 128), both=1,
        kw=dict(n_seeds=3, excl_bp=4, n_cand=5)),
}


@pytest.mark.parametrize("name", list(_JAX_CASES))
def test_index_sharded_plain_equals_jax(name):
    """B17 through the port's mesh (K19's plain phases, an (8 / 4, 4) mesh
    of CPU shards) == the JAX function on its (2, 4) mesh: mapped, pos,
    rev and mask; Lp 1024 (kMaxW) with one seed, and wide keys with
    n_seeds x C = 15 columns over 4 shards and both_strands."""
    cs = _JAX_CASES[name]
    ref = _ref()
    k, Lp = cs["k"], cs["Lp"]
    codes, dege, lengths = _reads(ref, 32, cs["lens"], k, seed=3)
    c, d = _gridify(codes, dege, lengths, Lp)
    n = len(ref)
    kw = dict(seed_len=k, seed_max_occ=32, max_mis=cs.get("max_mis", 5),
              both_strands=cs.get("both", 0))
    jref = jidx.RefSeq(ref, np.zeros(n, bool), ["t"], np.array([0, n]), "x")
    jx = jidx.build_from_ref(jref, JParams(**kw))
    idx, sh, _ = _shards(ref, k)
    want = jm.align_blocks_index_sharded(
        jm.make_mesh(8, ctx_shards=D), JParams(**kw),
        jm.shard_ref_index(jx, D), c, d, lengths, **cs["kw"])
    got = tm.align_blocks_index_sharded(
        tm.Mesh([CPU] * 8, ctx_shards=D), CodecParams(**kw), sh, c, d,
        lengths, **cs["kw"])
    assert np.asarray(want[0]).sum() > len(lengths) // 3
    assert not np.asarray(want[0])[[3, 4, 9, 11]].any()   # short, degenerate
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("layout", [[[0, 1], [2, 3]], [[0], [1, 2, 3]],
                                    [[0], [1], [2], [3]]],
                         ids=["2+2", "1+3", "1+1+1+1"])
def test_device_groups_equal_one_device(layout, monkeypatch):
    """The shards of a row grouped on several devices (a launch a phase
    and group, each collective a reduction over the group's stacked
    shards and then across the groups; the groups forced on the CPU
    shards) == every shard on one device: mapped, pos, rev, mask."""
    ref = _ref()
    codes, dege, lengths = _reads(ref, 24, (50, 128), 14, seed=8)
    c, d = _gridify(codes, dege, lengths, 128)
    _, sh, _ = _shards(ref, 14)
    p = CodecParams(seed_len=14, seed_max_occ=16, max_mis=5)
    kw = dict(n_seeds=3, excl_bp=5, n_cand=7)
    want = tm.align_blocks_index_sharded(tm.Mesh([CPU] * 4, ctx_shards=D),
                                         p, sh, c, d, lengths, **kw)
    monkeypatch.setattr(tm, "_device_groups", lambda devs: layout)
    sh.pop("_dev")
    got = tm.align_blocks_index_sharded(tm.Mesh([CPU] * 4, ctx_shards=D),
                                        p, sh, c, d, lengths, **kw)
    assert want[0].sum() > 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_device_groups_adjacent_shards():
    """A row's shards grouped by device in shard order; a device whose
    shards are not adjacent is refused."""
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    assert tm._device_groups([a, a, b, b]) == [[0, 1], [2, 3]]
    assert tm._device_groups([a, b, b, b]) == [[0], [1, 2, 3]]
    assert tm._device_groups([CPU] * 4) == [[0, 1, 2, 3]]
    with pytest.raises(ValueError, match="adjacent"):
        tm._device_groups([a, b, a, b])
