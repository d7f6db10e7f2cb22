"""fastqueeze_tpu_torch's seed aligner and aligned paths against fastqueeze_tpu.

Kernel level: the plain versions of K8 (align_batch) and K9 (indel_batch)
against the JAX package's _align_batch / _indel_batch on the same seeded
grids, and against the native host mirror.  Pipeline level: archives of
the reference-aligned path (frozen and adaptive, -q, duplicate-heavy
input, N bases, variable lengths) and of self-referential blocks (auto
probe and -S), written by the port on the CPU through both routes (the
native host aligner, and FASTQUEEZE_ALIGN_EXEC=device: the plain
versions), must equal the JAX package's byte for byte, and each package
decodes the other's.  Index files load across packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.align import hash as jh
from fastqueeze_tpu.align import index as jidx
from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.pipeline import aligned as ja
from fastqueeze_tpu.pipeline import driver as jd
from fastqueeze_tpu_torch.align import hash as th
from fastqueeze_tpu_torch.align import index as tidx
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import ArcReader
from fastqueeze_tpu_torch.container.encap import iter_tlv
from fastqueeze_tpu_torch.io import native
from fastqueeze_tpu_torch.ops import kernels
from fastqueeze_tpu_torch.pipeline import aligned as ta
from fastqueeze_tpu_torch.pipeline import blockcodec
from fastqueeze_tpu_torch.pipeline import driver as td

_BASES = np.frombuffer(b"ACGT", np.uint8)
_LP = 128


# --- kernel level -----------------------------------------------------------

def _kernel_reads(rng, ref, n):
    """Reads of every kind: clean, point errors, a deletion, an
    insertion, two indels, random (unmappable), shorter than k, and
    reads that wrap around the reference's end (every candidate falls
    outside it: the all-invalid fallback); ~40% reverse strand."""
    reads = []
    for i in range(n):
        kind = i % 8
        L = int(rng.integers(70, 110))
        s = int(rng.integers(100, len(ref) - L - 200))
        r = ref[s:s + L + 6].copy()
        if kind == 1:
            at = rng.integers(0, L, 9)
            r[at] = (r[at] + rng.integers(1, 4, 9)) % 4
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
        r = r[:L]
        if kind != 7 and rng.random() < 0.4:
            r = (3 - r)[::-1].copy()
        reads.append(r)
    return reads


@pytest.fixture(scope="module")
def kernel_fixture(tmp_path_factory):
    """{k: (JAX aligner, port aligner, codes grid, dege grid, lengths,
    flat arrays)} over a 24 kbp reference with an injected repeat family
    (deep candidate lists for the rescue tier's prefilter)."""
    d = tmp_path_factory.mktemp("torch_align_kernels")
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 24_000).astype(np.uint8)
    for j in range(40):
        ref[8000 + j * 70:8000 + j * 70 + 60] = ref[:60]
    fa = str(d / "ref.fa")
    with open(fa, "wb") as fh:
        fh.write(b">r\n" + _BASES[ref].tobytes() + b"\n")
    reads = _kernel_reads(rng, ref, 240)
    for j in range(16):          # reads from inside the repeat family
        p = 8000 + int(rng.integers(0, 35)) * 70 + int(rng.integers(0, 8))
        reads.append(ref[p:p + 100].copy())
    lengths = np.array([len(r) for r in reads], np.int64)
    codes = np.concatenate(reads)
    dege = np.zeros(len(codes), bool)
    dege[int(lengths[:9].sum()) + 3] = True          # read 9 carries an N
    cg, dg = jh._gridify(codes, dege, lengths, _LP)
    out = {}
    for k in (14, 22):
        jal = jh.Aligner(jidx.build_from_ref(jidx.load_fasta(fa),
                                             JParams(seed_len=k)),
                         JParams(seed_len=k))
        tal = th.Aligner(tidx.build_from_ref(tidx.load_fasta(fa),
                                             CodecParams(seed_len=k)),
                         CodecParams(seed_len=k))
        out[k] = (jal, tal, cg, dg, lengths, codes, dege)
    return out


def _cfgs(k, jal, **kw):
    base = dict(k=k, stride=2, n_cand=64, max_mis=7, both_strands=0, lp=_LP)
    base.update(kw)
    jcfg = jh.AlignConfig(l1_shift=jal._l1_shift,
                          search_steps=jal._search_steps, wide=k > 15,
                          **base)
    return jcfg, th.AlignConfig(**base)


def _grids(cg, dg, lengths):
    return (torch.from_numpy(cg), torch.from_numpy(dg),
            torch.from_numpy(lengths.astype(np.int32)))


def _native_args(tal, codes, dege, lengths, cfg):
    return (tal._h_keys, tal._h_offsets, tal._h_positions, tal._h_packed,
            tal._h_l1, tal._l1_shift, tal._search_steps, tal.ref_len, codes,
            dege, np.cumsum(lengths) - lengths, lengths, _LP, cfg.k,
            cfg.stride, cfg.n_cand, cfg.max_mis, cfg.n_seeds, cfg.excl_bp,
            cfg.probe_k)


_K8 = {
    "fwd": dict(strand="fwd", probe_k=16),
    "rc": dict(strand="rc", probe_k=16),
    "both_strands": dict(both_strands=1, probe_k=16),
    "rc_fallback": dict(probe_k=16),
    # repeat reads keep more than K probe survivors: only the first K of
    # the stable order verify
    "rescue_K4": dict(n_cand=1024, n_seeds=6, excl_bp=7, probe_k=4),
    "rescue": dict(n_cand=1024, n_seeds=6, excl_bp=7),
}


@pytest.mark.parametrize("k", [14, 22])
@pytest.mark.parametrize("name", sorted(_K8))
def test_align_batch_plain_matches_jax_and_native(kernel_fixture, k, name):
    jal, tal, cg, dg, lengths, codes, dege = kernel_fixture[k]
    jcfg, cfg = _cfgs(k, jal, **_K8[name])
    want = [np.asarray(x) for x in jh._align_batch(
        jcfg, *jal._dev_arrays(), jnp.int32(jal.ref_len), jnp.asarray(cg),
        jnp.asarray(dg), jnp.asarray(lengths.astype(np.int32)))]
    got = [x.numpy() for x in kernels.align_batch(
        *_grids(cg, dg, lengths), tal.dev_index("cpu"), cfg)]
    m = want[0]
    assert m.sum() > 10
    if cfg.probe_k == 4:
        # the repeat family's lists run deeper than 2K: the prefilter runs
        assert np.diff(tal._h_offsets.astype(np.int64)).max() > 2 * 4
    assert np.array_equal(got[0], m)
    assert np.array_equal(got[1][m], want[1][m].astype(np.int64))
    assert np.array_equal(got[2], want[2])
    assert np.array_equal(got[3], want[3])
    sm = {"fwd": 0, "rc": 1, "both": 2}[cfg.strand]
    nat = native.align_batch(*_native_args(tal, codes, dege, lengths, cfg),
                             sm, cfg.both_strands)
    assert np.array_equal(got[0], nat[0])
    assert np.array_equal(got[1], nat[1])        # every read, fallbacks too
    assert np.array_equal(got[3], nat[3])


@pytest.mark.parametrize("k", [14, 22])
@pytest.mark.parametrize("G,ops", [(3, 1), (3, 2)])
def test_indel_batch_plain_matches_jax_and_native(kernel_fixture, k, G, ops):
    jal, tal, cg, dg, lengths, codes, dege = kernel_fixture[k]
    jcfg, cfg = _cfgs(k, jal, n_cand=1024, n_seeds=6, excl_bp=7)
    want = [np.asarray(x) for x in jh._indel_batch(
        jcfg, G, ops, *jal._dev_arrays(), jnp.int32(jal.ref_len),
        jnp.asarray(cg), jnp.asarray(dg),
        jnp.asarray(lengths.astype(np.int32)))]
    got = [x.numpy() for x in kernels.indel_batch(
        *_grids(cg, dg, lengths), tal.dev_index("cpu"), cfg, G, ops)]
    nat = native.indel_batch(*_native_args(tal, codes, dege, lengths, cfg),
                             G, ops)
    f = got[0]
    assert f.sum() > 60
    assert (got[3][f] != 0).sum() > 10
    if ops == 2:
        assert (got[5][f] != 0).sum() > 3
    # the native mirror: equal everywhere it is observable
    assert np.array_equal(f, nat[0])
    assert np.array_equal(got[1], nat[1])      # anchors of every read
    for a, b in zip(got[2:], nat[2:]):
        assert np.array_equal(a[f], b[f])
    # the JAX kernel: equal on every read whose anchors agree; anchors
    # differ only on prefilter fallbacks (all candidates pruned), which the
    # JAX kernel ranks by their two-word probe count and the native mirror
    # by the first word's count + 8 once that alone is over max_mis
    ix = tal.dev_index("cpu")
    c, d, ln = _grids(cg, dg, lengths)
    rc, rd = kernels._rc_grid(c, d, ln.long())
    one = jax.jit(jh._one_strand, static_argnums=0)
    moved = np.zeros(len(f), bool)
    for cc, dd in ((c, d), (rc, rd)):
        mis, pos = kernels._one_strand_plain(cfg, ix, cc, dd, ln.long())
        jpos = np.asarray(one(jcfg, *jal._dev_arrays(),
                              jnp.int32(jal.ref_len),
                              jnp.asarray(cc.numpy().astype(np.uint8)),
                              jnp.asarray(dd.numpy()),
                              jnp.asarray(ln.numpy()))[1]).astype(np.int32)
        diff = jpos != pos.numpy()
        assert (mis.numpy()[diff] >= kernels.ALIGN_BIG).all()
        moved |= diff
    assert (mis.numpy() >= kernels.ALIGN_BIG)[7::8].all()   # all-invalid
    keep = ~moved
    assert (f & keep).sum() > 20
    assert np.array_equal(want[0][keep], f[keep])
    fk = f & keep
    for a, b in zip(want[1:], got[1:]):
        assert np.array_equal(np.asarray(a)[fk], np.asarray(b)[fk])


@pytest.fixture
def one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them from stalling on busy cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fused_fixture():
    """{gapless, indel}: (JAX aligner, port aligner, params, flat reads) of
    tests/test_fused_align.py's _mk reads over a 20 kbp reference, with
    its tier-2 settings."""
    from test_fused_align import _mk
    out = {}
    for name, seed, kw in (("gapless", 31, {}),
                           ("indel", 32, dict(max_indel=3, indel_ops=2))):
        ref, cf, df, ln = _mk(np.random.default_rng(seed),
                              indel=name == "indel")
        kw = dict(seed_max_occ=16, seed_big_occ=128, rescue_seeds=4, **kw)
        jal = jh.Aligner(jidx.build_from_ref(ref, JParams(**kw)),
                         JParams(**kw))
        tal = th.Aligner(tidx.build_from_ref(ref, CodecParams(**kw)),
                         CodecParams(**kw))
        out[name] = (jal, tal, cf, df, ln)
    return out


@pytest.mark.parametrize("variant", ["rescue", "indel", "both"])
def test_rescue_indel_fused_plain_matches_jax(fused_fixture, variant,
                                              one_torch_thread):
    """K14's plain version against the JAX _rescue_indel_fused: every read
    of the indel set in a shuffled todo list of 512 slots, a tenth of the
    listed slots and the 112 padding slots with do false (pointing at
    real rows)."""
    jal, tal, cf, df, ln = fused_fixture["indel"]
    lp = th.lp_bucket(int(ln.max()))
    cg, dg = jh._gridify(cf, df, ln, lp)
    rng = np.random.default_rng(5)
    cap = 512
    idx = rng.integers(0, len(ln), cap).astype(np.int32)
    idx[:len(ln)] = rng.permutation(len(ln))
    do = np.zeros(cap, bool)
    do[:len(ln)] = rng.random(len(ln)) >= 0.1
    G, ops = (0, 0) if variant == "rescue" else (3, 2)
    base = dict(k=14, stride=2, n_cand=128, max_mis=7, both_strands=0,
                lp=lp, n_seeds=4, excl_bp=7)
    jcfg = jh.AlignConfig(l1_shift=jal._l1_shift,
                          search_steps=jal._search_steps, wide=False, **base)
    cfg = th.AlignConfig(**base)
    rescue = variant != "indel"
    want = [np.asarray(x) for x in jh._rescue_indel_fused(
        jcfg if rescue else None, jcfg, G, ops, *jal._dev_arrays(),
        jnp.int32(jal.ref_len), jnp.asarray(cg), jnp.asarray(dg),
        jnp.asarray(ln.astype(np.int32)), jnp.asarray(idx),
        jnp.asarray(do))]
    got = [x.numpy() for x in kernels.rescue_indel_fused(
        torch.from_numpy(cg), torch.from_numpy(dg),
        torch.from_numpy(ln.astype(np.int32)), torch.from_numpy(idx),
        torch.from_numpy(do), tal.dev_index("cpu"), cfg if rescue else None,
        cfg, G, ops)]
    m2, f = got[0], got[4]
    assert np.array_equal(m2, want[0]) and np.array_equal(f, want[4])
    assert not (m2 | f)[~do].any()
    if rescue:
        assert m2.sum() > 300
    if ops:
        assert f.sum() > 10 and (got[7][f] != 0).any()
    for sel, lo, hi in ((m2, 1, 4), (f, 5, 12)):
        for a, b in zip(got[lo:hi], want[lo:hi]):
            assert np.array_equal(a[sel], b[sel].astype(a.dtype))


@pytest.mark.parametrize("name", ["gapless", "indel"])
def test_fused_align_matches_jax_classic_and_native(fused_fixture, name,
                                                    monkeypatch,
                                                    one_torch_thread):
    """Aligner.align with FASTQUEEZE_FUSED_ALIGN=1 on the kernel route (the
    plain versions here) decides every read as the port's classic tier
    chain, the JAX package's fused flow and the native host mirror."""
    jal, tal, cf, df, ln = fused_fixture[name]
    calls = []
    fused = kernels.rescue_indel_fused
    monkeypatch.setattr(kernels, "rescue_indel_fused",
                        lambda *a: calls.append(1) or fused(*a))
    runs = {}
    for key, route, on in (("fused", "device", "1"),
                           ("classic", "device", "0"),
                           ("native", "host", "1")):
        monkeypatch.setenv("FASTQUEEZE_ALIGN_EXEC", route)
        monkeypatch.setenv("FASTQUEEZE_FUSED_ALIGN", on)
        runs[key] = tal.align(cf, df, ln, "cpu")
        if key == "fused":
            assert calls, "the fused flow never ran K14"
            monkeypatch.setenv("FASTQUEEZE_ALIGN_EXEC", "device")
            runs["jax"] = jal.align(cf, df, ln)
    got = runs.pop("fused")
    m = got.mapped
    assert m.sum() > 300
    if name == "indel":
        assert (got.gap_len[m] != 0).any()
    for key, want in runs.items():
        assert np.array_equal(want.mapped, m), key
        fields = range(8) if name == "indel" else range(4)
        for i in fields:
            assert np.array_equal(np.asarray(got[i])[m],
                                  np.asarray(want[i])[m]), (key, i)


def test_long_reads_name_their_roadmap_item(kernel_fixture):
    """A read longer than align_max_len stays unmapped at read level (the
    long-read chunk tier maps it) and the batch's other reads align as the
    JAX package aligns them."""
    jal, tal, cg, dg, lengths, codes, dege = kernel_fixture[14]
    n = tal.params.align_max_len + 1
    c = np.concatenate([codes, np.random.default_rng(1).integers(
        0, 4, n).astype(np.uint8)])
    d = np.concatenate([dege, np.zeros(n, bool)])
    ln = np.append(lengths, n)
    want = jal.align(c, d, ln)
    got = tal.align(c, d, ln, "cpu")
    assert not got.mapped[-1] and got.mapped.sum() > 40
    assert got.mis_mask.shape == want.mis_mask.shape == (len(ln), _LP)
    for a, b in zip(got[:4], want[:4]):
        assert np.array_equal(a, b)


# --- pipeline level ---------------------------------------------------------

def _genome_fastq(path, ref, n, rng, dup_frac=0.0):
    """Reads of 60-130 bp from ``ref``: ~3% point errors on a seventh,
    indels on two sevenths, random reads, a few N bases, ~40% reverse
    strand, plus exact duplicates at ``dup_frac``."""
    recs = []
    for r in range(n):
        if recs and rng.random() < dup_frac:
            recs.append(recs[int(rng.integers(0, len(recs)))])
            continue
        L = int(rng.integers(60, 131))
        s = int(rng.integers(0, len(ref) - L - 5))
        c = ref[s:s + L + 4].copy()
        kind = r % 7
        if kind == 0:
            c = rng.integers(0, 4, L).astype(np.uint8)
        elif kind == 1:
            e = rng.random(len(c)) < 0.03
            c[e] = (c[e] + 1) % 4
        elif kind == 2:
            at = int(rng.integers(20, L - 20))
            c = np.concatenate([c[:at], c[at + int(rng.integers(1, 4)):]])
        elif kind == 3:
            at = int(rng.integers(20, L - 20))
            c = np.concatenate([c[:at], rng.integers(0, 4, 2)
                                .astype(np.uint8), c[at:]])
        c = c[:L]
        if rng.random() < 0.4:
            c = (3 - c)[::-1]
        seq = bytearray(_BASES[c].tobytes())
        if r % 29 == 0:
            seq[int(rng.integers(0, L))] = ord("N")
        q = (np.clip(np.cumsum(rng.integers(-1, 2, L)) + 30, 2, 40)
             + 33).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (r, bytes(seq), q.tobytes()))
    with open(path, "wb") as fh:
        fh.write(b"".join(recs))


_ALIGNED = {
    "adaptive": (dict(), 0.0),
    "frozen": (dict(use_model=1, block_bytes=60_000), 0.0),
    "q": (dict(seed_len=22, max_indel=3), 0.0),
    "dup_heavy": (dict(), 0.4),
}


@pytest.fixture(scope="module")
def aligned_archives(tmp_path_factory):
    """{config: (input, ref, jax archive, port native-route archive, port
    plain-route archive)}."""
    d = tmp_path_factory.mktemp("torch_aligned")
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, 30_000).astype(np.uint8)
    fa = str(d / "ref.fa")
    with open(fa, "wb") as fh:
        fh.write(b">c1 first\n" + _BASES[ref[:15_000]].tobytes() + b"\n>c2\n"
                 + _BASES[ref[15_000:]].tobytes() + b"\n")
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, (kw, dup) in _ALIGNED.items():
            fq = str(d / f"{name}.fq")
            _genome_fastq(fq, ref, 900, rng, dup)
            arcs = [str(d / f"{w}_{name}.fqz") for w in ("j", "t", "td")]
            ja.compress_se_aligned(JParams(**kw), fa, fq, arcs[0])
            calls = []
            for i, route in ((1, ""), (2, "device")):
                for env in ("FASTQUEEZE_ALIGN_EXEC", "FASTQUEEZE_FROZEN_EXEC",
                            "FASTQUEEZE_ADAPT_EXEC"):
                    mp.setenv(env, route)
                native.ALIGN_CALLS["align_batch"] = 0
                ta.compress_se_aligned(CodecParams(**kw), fa, fq, arcs[i],
                                       device="cpu")
                calls.append(native.ALIGN_CALLS["align_batch"])
                mp.undo()
            out[name] = (fq, fa, *arcs, calls)
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("name", sorted(_ALIGNED))
def test_aligned_archive_bytes_equal(aligned_archives, name):
    fq, fa, jarc, tarc, tdarc, _ = aligned_archives[name]
    with open(jarc, "rb") as fh:
        want = fh.read()
    for arc in (tarc, tdarc):
        with open(arc, "rb") as fh:
            assert fh.read() == want
    with ArcReader(tarc) as r:
        assert r.params.aligned == 1
        assert (r.model_blob is not None) == (name == "frozen")
        secs = [dict(iter_tlv(r.read_block(i))) for i in range(len(r.blocks))]
    meta = [__import__("json").loads(s[blockcodec.TAG_META]) for s in secs]
    assert sum(m["nm"] for m in meta) > 300
    if name == "q":
        assert any(blockcodec.TAG_ACIGF in s for s in secs)
    if name == "dup_heavy":
        assert all(m.get("nsd", 0) > 50 for m in meta)


@pytest.mark.parametrize("name", sorted(_ALIGNED))
def test_aligned_cross_decode(aligned_archives, name, tmp_path):
    fq, fa, jarc, tarc, _, _ = aligned_archives[name]
    with open(fq, "rb") as fh:
        raw = fh.read()
    td.decompress(jarc, str(tmp_path / "t"), force=True, device="cpu",
                  ref=fa)
    jd.decompress(tarc, str(tmp_path / "j"), ref=fa, force=True)
    for out in ("t", "j"):
        with open(tmp_path / f"{out}.fastq", "rb") as fh:
            assert fh.read() == raw


@pytest.mark.parametrize("name", sorted(_ALIGNED))
def test_device_route_never_calls_the_host_aligner(aligned_archives, name):
    native_calls, device_calls = aligned_archives[name][-1]
    assert native_calls > 0 and device_calls == 0


def test_decode_refuses_missing_or_wrong_reference(aligned_archives,
                                                   tmp_path):
    fq, fa, _, tarc, _, _ = aligned_archives["adaptive"]
    with pytest.raises(ValueError, match="needs the same FASTA"):
        td.decompress(tarc, str(tmp_path / "a"), device="cpu")
    wrong = tmp_path / "wrong.fa"
    wrong.write_bytes(open(fa, "rb").read().replace(b">c2", b">c3"))
    with pytest.raises(ValueError, match="wrong reference"):
        td.decompress(tarc, str(tmp_path / "b"), device="cpu",
                      ref=str(wrong))


def test_index_files_load_across_packages(tmp_path):
    rng = np.random.default_rng(5)
    fa = tmp_path / "ref.fa"
    fa.write_bytes(b">x\n" + _BASES[rng.integers(0, 4, 20_000)].tobytes()
                   + b"NNNN\n")
    for k in (14, 22):
        jp, tp = JParams(seed_len=k), CodecParams(seed_len=k)
        jpath = jidx.build_index(str(fa), jp, str(tmp_path / f"j{k}.idx"))
        tpath = tidx.build_index(str(fa), tp, str(tmp_path / f"t{k}.idx"))
        with open(jpath, "rb") as a, open(tpath, "rb") as b:
            assert a.read() == b.read()
        for shared in (False, True):
            got = tidx.load_index_file(jpath, shared=shared)
            want = jidx.load_index_file(tpath, shared=shared)
            assert (got.k, got.ref_len, got.ref_md5) == (want.k, want.ref_len,
                                                        want.ref_md5)
            for f in ("keys", "offsets", "positions", "packed"):
                assert np.array_equal(getattr(got, f), getattr(want, f))
    # load_index picks the file up next to the FASTA, and refuses an MD5
    # that is not the archive's
    os.replace(tmp_path / "t14.idx", tidx.index_path(str(fa)))
    idx, ref = tidx.load_index(str(fa), CodecParams())
    assert idx.n_keys > 0 and ref.md5 == idx.ref_md5
    with pytest.raises(ValueError, match="wrong reference"):
        tidx.load_index(str(fa), CodecParams(), expect_md5="0" * 32)


@pytest.fixture(scope="module")
def selfref_archives(tmp_path_factory):
    """{config: (input, jax archive, port archive)} on a coverage input
    (~25x over a 12 kbp genome) where the auto probe turns self-ref on."""
    d = tmp_path_factory.mktemp("torch_selfref")
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 12_000).astype(np.uint8)
    recs = []
    for r in range(3000):
        s = int(rng.integers(0, len(genome) - 100))
        c = genome[s:s + 100].copy()
        e = rng.random(100) < 0.01
        c[e] = (c[e] + 1) % 4
        if rng.random() < 0.5:
            c = (3 - c)[::-1]
        seq = bytearray(_BASES[c].tobytes())
        if r % 97 == 0:
            seq[40] = ord("N")
        q = (np.clip(np.cumsum(rng.integers(-1, 2, 100)) + 30, 2, 40)
             + 33).astype(np.uint8)
        recs.append(b"@s%d\n%s\n+\n%s\n" % (r, bytes(seq), q.tobytes()))
    fq = str(d / "cov.fq")
    with open(fq, "wb") as fh:
        fh.write(b"".join(recs))
    out = {}
    for name, kw in (("auto", {}), ("S", dict(self_align=1)),
                     ("S_frozen", dict(self_align=1, use_model=1))):
        jarc, tarc = str(d / f"j_{name}.fqz"), str(d / f"t_{name}.fqz")
        jd.compress_se(JParams(**kw), fq, jarc)
        td.compress_se(CodecParams(**kw), fq, tarc, device="cpu")
        out[name] = (fq, jarc, tarc)
    return out


@pytest.mark.parametrize("name", ["auto", "S", "S_frozen"])
def test_selfref_archive_bytes_equal(selfref_archives, name):
    fq, jarc, tarc = selfref_archives[name]
    with open(jarc, "rb") as a, open(tarc, "rb") as b:
        assert a.read() == b.read()
    with ArcReader(tarc) as r:
        assert r.params.self_align == 1
        secs = dict(iter_tlv(r.read_block(0)))
    assert blockcodec.TAG_AMAP in secs


@pytest.mark.parametrize("name", ["auto", "S", "S_frozen"])
def test_selfref_cross_decode(selfref_archives, name, tmp_path):
    fq, jarc, tarc = selfref_archives[name]
    with open(fq, "rb") as fh:
        raw = fh.read()
    td.decompress(jarc, str(tmp_path / "t"), force=True, device="cpu")
    jd.decompress(tarc, str(tmp_path / "j"), force=True)
    for out in ("t", "j"):
        with open(tmp_path / f"{out}.fastq", "rb") as fh:
            assert fh.read() == raw
