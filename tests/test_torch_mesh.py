"""fastqueeze_tpu_torch's multi-device path against fastqueeze_tpu's.

The port's mesh is [cpu] * D through its one seam (parallel/mesh.py
visible_devices, monkeypatched), so every shard shares the CPU and every
kernel runs its plain version; the JAX side runs on its 8 virtual CPU
devices (tests/conftest.py).  Library level: the mesh trainer (B15, K13's
halves), block coding (B19), block-DP alignment (B16), the ctx-sharded
frozen decode (B18, K18's plain version; also against the port's own
frozen_decode_plain), shard_ref_index and the index-sharded aligner
(B17, K19's plain version) equal the JAX functions on the same seeded
inputs.  Archive level: SE and PE --mesh 2 archives, an aligned archive
through the ShardedAligner and the ctx-shard decode gate equal the JAX
package's byte for byte, and each package decodes the other's.  Every
output is an integer or a byte, so every comparison is exact (tolerance
0).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.align import hash as jh
from fastqueeze_tpu.align import index as jidx
from fastqueeze_tpu.align import sharded as jsharded
from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.models.base import QualModel as JQual
from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu.parallel import mesh as jm
from fastqueeze_tpu.pipeline import aligned as jal
from fastqueeze_tpu.pipeline import driver as jd
from fastqueeze_tpu.pipeline import pe as jpe
from fastqueeze_tpu_torch.align import hash as th
from fastqueeze_tpu_torch.align import index as tidx
from fastqueeze_tpu_torch.align import sharded as tsharded
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import ArcReader
from fastqueeze_tpu_torch.models.base import QualModel
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import kernels
from fastqueeze_tpu_torch.parallel import mesh as tm
from fastqueeze_tpu_torch.pipeline import aligned as tal
from fastqueeze_tpu_torch.pipeline import driver as td
from fastqueeze_tpu_torch.pipeline import pe as tpe

import __graft_entry__ as graft

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from genome_fixture import make_genome, sample_reads, write_fasta, \
    write_fastq  # noqa: E402

CPU = torch.device("cpu")
B, T, L = 4, 64, 32
_SMALL = dict(slevel=0, lanes_min=16, lanes_max=32, lane_target_symbols=512,
              block_bytes=16384)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them from stalling on busy cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpus(monkeypatch, n: int):
    monkeypatch.setattr(tm, "visible_devices", lambda kind="cuda": [CPU] * n)


def _models():
    return (QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=2),
            JQual(alphabet=40, init=1, inc=8, cap=8192, qlevel=2))


def _grids():
    """graft._example_grids' (B, T, L) blocks: every lane 16-base reads
    back to back, so the port's (B, J, L) read-length grid is all 16."""
    syms, valid, pos = graft._example_grids(B=B, T=T, L=L, qmax=39)
    cgrid = np.full((B, T // 16, L), 16, np.int32)
    return syms, valid, pos, cgrid


# --- the library functions ---------------------------------------------------

@pytest.mark.parametrize("ctx", [1, 2, 4])
def test_train_counts_sharded_equals_jax(ctx):
    """B15 on a (4 / ctx, ctx) mesh: the row blocks of the ctx shards,
    stacked, equal the JAX mesh trainer's table; and K13's halves equal
    K13 (train_counts) on one block."""
    tmod, jmod = _models()
    syms, valid, pos, cgrid = _grids()
    want = jm.train_counts_sharded(jm.make_mesh(4, ctx_shards=ctx), jmod,
                                   jnp.asarray(syms), jnp.asarray(valid),
                                   {"pos": jnp.asarray(pos)})
    mesh = tm.Mesh([CPU] * 4, ctx_shards=ctx)
    parts = tm.train_counts_sharded(mesh, tmod, syms, cgrid)
    assert len(parts) == ctx
    got = torch.cat(parts).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    s0, c0 = torch.from_numpy(syms[0]), torch.from_numpy(cgrid[0])
    h = kernels.train_hist(s0, c0, tmod, torch.zeros(
        (tmod.n_ctx, tmod.alphabet), dtype=torch.int32))
    np.testing.assert_array_equal(kernels.train_rows(h, tmod).numpy(),
                                  kernels.train_counts(s0, c0, tmod).numpy())


@pytest.mark.parametrize("nb,nc", [(4, 1), (2, 2), (1, 4)])
def test_row_pass_sum_equals_jax(nb, nc, monkeypatch):
    """The summing row pass's plain version, given the block shards'
    partials (K13's histogram half over each shard's blocks), on each ctx
    shard's row block == that block of the JAX mesh trainer's table; and
    B15 on the same mesh with its ctx shards in two device groups
    (mesh._device_groups patched: a row pass a group) == the same
    table."""
    tmod, jmod = _models()
    syms, valid, pos, cgrid = _grids()
    want = np.asarray(jm.train_counts_sharded(
        jm.make_mesh(4, ctx_shards=nc), jmod, jnp.asarray(syms),
        jnp.asarray(valid), {"pos": jnp.asarray(pos)}))
    per = B // nb
    hists = []
    for b in range(nb):
        h = torch.zeros((tmod.n_ctx, tmod.alphabet), dtype=torch.int32)
        for i in range(b * per, (b + 1) * per):
            kernels.train_hist(torch.from_numpy(syms[i]),
                               torch.from_numpy(cgrid[i]), tmod, h)
        hists.append(h)
    n = tmod.n_ctx // nc
    for c in range(nc):
        got = kernels.train_rows_sum([h[c * n:(c + 1) * n] for h in hists],
                                     tmod)
        np.testing.assert_array_equal(got.numpy(), want[c * n:(c + 1) * n])
    groups = ([[0]] if nc == 1 else
              [list(range(i, i + nc // 2)) for i in (0, nc // 2)])
    monkeypatch.setattr(tm, "_device_groups", lambda devs: groups)
    parts = tm.train_counts_sharded(tm.Mesh([CPU] * 4, ctx_shards=nc), tmod,
                                    syms, cgrid)
    assert len(parts) == nc
    np.testing.assert_array_equal(torch.cat(parts).numpy(), want)


def test_encode_blocks_sharded_equals_jax():
    """B19: every block's words, emits and final states."""
    tmod, jmod = _models()
    syms, valid, pos, cgrid = _grids()
    nh = je._n_halve(jmod, L)
    counts0 = np.asarray(je.init_counts(jmod))
    jw, jemit, jx = jm.encode_blocks_sharded(
        jm.make_mesh(4, ctx_shards=1), jmod, nh, jnp.asarray(counts0),
        jnp.asarray(syms), jnp.asarray(valid), jnp.asarray(pos))
    got = tm.encode_blocks_sharded(tm.Mesh([CPU] * 4), tmod,
                                   te._n_halve(tmod, L), counts0, syms,
                                   cgrid)
    assert len(got) == B
    for b, (w, e, x) in enumerate(got):
        np.testing.assert_array_equal(w.numpy().view(np.uint16),
                                      np.asarray(jw[b]))
        np.testing.assert_array_equal(e.numpy(),
                                      np.asarray(jemit[b]).astype(np.uint8))
        np.testing.assert_array_equal(x.numpy().view(np.uint32),
                                      np.asarray(jx[b]))


@pytest.fixture(scope="module")
def small_ref():
    """A seeded 20 kbp reference, 64 reads of 80 bp (a third reverse
    complemented, 0-3 substitutions each) and the grids both packages
    take (test_mesh.py's inputs)."""
    rng = np.random.default_rng(21)
    ref_codes = rng.integers(0, 4, 20000).astype(np.uint8)
    R, Lr = 64, 80
    starts = rng.integers(0, 20000 - Lr, R)
    codes = np.zeros((R, Lr), np.uint8)
    for i, s in enumerate(starts):
        c = ref_codes[s:s + Lr].copy()
        mp = rng.integers(0, Lr, rng.integers(0, 4))
        c[mp] = (c[mp] + 1) % 4
        if i % 3 == 0:
            c = 3 - c[::-1]
        codes[i] = c
    cg = np.zeros((R, 128), np.uint8)
    cg[:, :Lr] = codes
    dg = np.zeros((R, 128), bool)
    dg[5, 10] = True                     # one read with an N
    return ref_codes, cg, dg, np.full(R, Lr, np.int64)


def _indexes(ref_codes, k):
    n = len(ref_codes)
    amb = np.zeros(n, bool)
    jp = JParams(seed_len=k, seed_max_occ=32, max_mis=5)
    tp = CodecParams(seed_len=k, seed_max_occ=32, max_mis=5)
    jref = jidx.RefSeq(ref_codes, amb, ["t"], np.array([0, n]), "x")
    tref = tidx.RefSeq(ref_codes, amb, ["t"], np.array([0, n]), "x")
    return (jidx.build_from_ref(jref, jp), jp,
            tidx.build_from_ref(tref, tp), tp)


def test_align_blocks_sharded_equals_jax(small_ref):
    """B16: K8 (its plain version) on each block shard against that
    device's copy of the index equals the JAX mesh aligner."""
    ref_codes, cg, dg, lengths = small_ref
    jidx_, jp, tidx_, tp = _indexes(ref_codes, 11)
    ja = jh.Aligner(jidx_, jp)
    ta = th.Aligner(tidx_, tp)
    jcfg = jh.AlignConfig(k=11, stride=jp.seed_stride, n_cand=32,
                          max_mis=5, both_strands=jp.both_strands, lp=128,
                          l1_shift=ja._l1_shift,
                          search_steps=ja._search_steps, wide=False)
    tcfg = th.AlignConfig(k=11, stride=tp.seed_stride, n_cand=32,
                          max_mis=5, both_strands=tp.both_strands, lp=128)
    c3, d3 = cg.reshape(4, 16, 128), dg.reshape(4, 16, 128)
    l3 = lengths.reshape(4, 16).astype(np.int32)
    want = jm.align_blocks_sharded(
        jm.make_mesh(4), jcfg, ja._keys, ja._offsets, ja._positions,
        ja._packed, ja._l1, int(jidx_.ref_len), jnp.asarray(c3),
        jnp.asarray(d3), jnp.asarray(l3))
    got = tm.align_blocks_sharded(tm.Mesh([CPU] * 4), ta, tcfg, c3, d3, l3)
    assert np.asarray(want[0]).sum() > 40
    for b, outs in enumerate(got):
        for g, w in zip(outs, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w[b]))


def test_ctx_sharded_decode_equals_jax():
    """B18 (K18's plain version) on an (8 / 4, 4) mesh against the JAX
    sharded decoder, on random states and words over a skewed random
    table (test_mesh.py:121's inputs): symbols and final states; the
    symbols also equal the port's unsharded frozen_decode_plain."""
    tmod, jmod = _models()
    W = 2048
    rng = np.random.default_rng(33)
    counts0 = (rng.integers(1, 50, (jmod.n_ctx, jmod.alphabet)) ** 2
               ).astype(np.int32)
    syms, valid, pos, cgrid = _grids()
    from fastqueeze_tpu.config import RANS_L
    states = rng.integers(RANS_L, 1 << 31, (B, L)).astype(np.uint32)
    words = rng.integers(0, 1 << 16, (B, W)).astype(np.uint16)
    js, jx = jm.decode_blocks_frozen_sharded(
        jm.make_mesh(8, ctx_shards=4), jmod, jnp.asarray(counts0),
        jnp.asarray(states), jnp.asarray(words), jnp.asarray(valid),
        jnp.asarray(pos))
    ts, tx = tm.decode_blocks_frozen_sharded(
        tm.Mesh([CPU] * 8, ctx_shards=4), tmod, counts0,
        states.view(np.int32), words.view(np.int16), cgrid, T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tx.numpy().view(np.uint32),
                                  np.asarray(jx))
    cum = kernels.quant_pack_plain(torch.from_numpy(counts0))[0]
    for b in range(B):
        full = kernels.frozen_decode_plain(
            torch.from_numpy(states[b].view(np.int32)),
            torch.from_numpy(words[b].view(np.int16)),
            torch.from_numpy(cgrid[b]), T, cum, tmod)
        np.testing.assert_array_equal(ts[b].numpy(), full.numpy())


@pytest.mark.parametrize("k", [11, 22])
@pytest.mark.parametrize("D", [2, 4])
def test_shard_ref_index_equals_jax(small_ref, k, D):
    jidx_, _, tidx_, _ = _indexes(small_ref[0], k)
    want = jm.shard_ref_index(jidx_, D)
    got = tm.shard_ref_index(tidx_, D)
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(w),
                                      err_msg=key)


@pytest.mark.parametrize("case", [
    dict(k=11), dict(k=22), dict(k=11, n_seeds=3, excl_bp=5, n_cand=16),
    dict(k=22, n_seeds=2, excl_bp=4)])
def test_index_sharded_align_equals_jax(small_ref, case):
    """B17 (K19's plain version) on an (8 / 4, 4) mesh equals the JAX
    function in mapped, pos, rev and mask: narrow and wide keys, one
    seed, and several seeds with the +-excl_bp exclusion."""
    ref_codes, cg, dg, lengths = small_ref
    k = case["k"]
    jidx_, jp, tidx_, tp = _indexes(ref_codes, k)
    kw = {n: case[n] for n in ("n_seeds", "excl_bp", "n_cand") if n in case}
    want = jm.align_blocks_index_sharded(
        jm.make_mesh(8, ctx_shards=4), jp, jm.shard_ref_index(jidx_, 4), cg,
        dg, lengths, **kw)
    got = tm.align_blocks_index_sharded(
        tm.Mesh([CPU] * 8, ctx_shards=4), tp, tm.shard_ref_index(tidx_, 4),
        cg, dg, lengths, **kw)
    assert np.asarray(want[0]).sum() > 40
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_collectives_on_shared_device():
    a = torch.tensor([1, -1, 5], dtype=torch.int32)
    b = torch.tensor([2, 3, -2], dtype=torch.int32)
    assert all(t.tolist() == [3, 2, 3] for t in tm.psum([a, b]))
    assert tm.pmin([a, b])[0].tolist() == [1, -1, -2]
    assert tm.pmax([a, b])[1].tolist() == [2, 3, 5]
    # unsigned: -1 and -2 are 0xFFFFFFFF and 0xFFFFFFFE
    assert tm.pmin([a, b], unsigned=True)[0].tolist() == [1, 3, 5]
    assert tm.pmax([a, b], unsigned=True)[0].tolist() == [2, -1, -2]


# --- archives --------------------------------------------------------------

def _fastq(rng, n, L=100):
    recs = []
    for i in range(n):
        seq = rng.choice(list(b"ACGT"), size=L).astype(np.uint8)
        qual = (rng.integers(0, 41, size=L) + 33).astype(np.uint8)
        recs.append(f"@m.{i} {i} length={L}\n{bytes(seq).decode()}\n+\n"
                    f"{bytes(qual).decode()}\n")
    return "".join(recs).encode()


def test_se_mesh2_archive_equals_jax(tmp_path, monkeypatch):
    """SE --mesh 2: PARAM carries mesh_n 2 and threads 2 as the JAX
    package writes them, the archive equals the JAX one, and each
    package decodes the other's."""
    _cpus(monkeypatch, 2)
    raw = _fastq(np.random.default_rng(7), 200)
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    t, j = str(tmp_path / "t.fqz"), str(tmp_path / "j.fqz")
    st = td.compress_se(CodecParams(**_SMALL, mesh_n=2), str(src), t,
                        device="cpu")
    jd.compress_se(JParams(**_SMALL, mesh_n=2), str(src), j)
    assert st["blocks"] > 2
    assert open(t, "rb").read() == open(j, "rb").read()
    with ArcReader(t) as r:
        assert (r.params.mesh_n, r.params.threads) == (2, 2)
    outs = td.decompress(j, str(tmp_path / "tb"), force=True, device="cpu")
    assert open(outs[0], "rb").read() == raw
    outs = jd.decompress(t, str(tmp_path / "jb"), force=True)
    assert open(outs[0], "rb").read() == raw


def test_pe_mesh2_archive_equals_jax(tmp_path, monkeypatch):
    _cpus(monkeypatch, 2)
    rng = np.random.default_rng(8)
    raw1, raw2 = _fastq(rng, 150), _fastq(rng, 150)
    (tmp_path / "a.fq").write_bytes(raw1)
    (tmp_path / "b.fq").write_bytes(raw2)
    a, b = str(tmp_path / "a.fq"), str(tmp_path / "b.fq")
    t, j = str(tmp_path / "t.fqz"), str(tmp_path / "j.fqz")
    st = tpe.compress_pe(CodecParams(**_SMALL, mesh_n=2), a, b, t,
                         device="cpu")
    jpe.compress_pe(JParams(**_SMALL, mesh_n=2), a, b, j)
    assert st["blocks"] > 1
    assert open(t, "rb").read() == open(j, "rb").read()
    outs = td.decompress(j, str(tmp_path / "tb"), force=True, device="cpu")
    assert [open(o, "rb").read() for o in outs] == [raw1, raw2]
    outs = jd.decompress(t, str(tmp_path / "jb"), force=True)
    assert [open(o, "rb").read() for o in outs] == [raw1, raw2]


def test_sharded_aligner_archive_equals_jax(tmp_path, monkeypatch):
    """SHARD_MIN_POSITIONS = 1 on both sides (every index past the
    single-device limit), 8 shards each (JAX: its 8 devices; the port: 8
    CPU shards): the port's aligner is a ShardedAligner, its archive
    equals the JAX one, and each package decodes the other's."""
    _cpus(monkeypatch, 8)
    monkeypatch.setattr(tsharded, "SHARD_MIN_POSITIONS", 1)
    monkeypatch.setattr(jsharded, "SHARD_MIN_POSITIONS", 1)
    monkeypatch.setattr(tal, "_REF_CACHE", {})
    monkeypatch.setattr(jal, "_REF_CACHE", {})
    codes, bounds = make_genome(200_000, seed=3)
    fa = str(tmp_path / "ref.fa")
    write_fasta(codes, bounds, fa)
    seqs, quals = sample_reads(codes, 400, 150,
                               np.random.default_rng(4), contam_frac=0.02)
    fq = str(tmp_path / "reads.fq")
    write_fastq(seqs, quals, fq)
    aligner, _ = tal.prepare_ref(CodecParams(), fa, "cpu")
    assert isinstance(aligner, tsharded.ShardedAligner)
    assert aligner.n_shards == 8
    t, j = str(tmp_path / "t.fqz"), str(tmp_path / "j.fqz")
    st = tal.compress_se_aligned(CodecParams(), fa, fq, t, device="cpu")
    jal.compress_se_aligned(JParams(), fa, fq, j)
    assert st["mapped"] / st["reads"] > 0.8, st
    assert open(t, "rb").read() == open(j, "rb").read()
    raw = open(fq, "rb").read()
    outs = td.decompress(j, str(tmp_path / "tb"), force=True, device="cpu",
                         ref=fa)
    assert open(outs[0], "rb").read() == raw
    outs = jd.decompress(t, str(tmp_path / "jb"), force=True, ref=fa)
    assert open(outs[0], "rb").read() == raw


def test_ctx_shard_gate_decode_equals_jax(tmp_path, monkeypatch):
    """The decode gate with CTX_SHARD_MIN_ENTRIES = 1 on test_mesh.py's
    deep-qctx frozen archive, decoded with mesh=4: K18's plain version
    runs (a spy counts its calls), the round trip is byte-exact, and the
    archive (equal to the JAX one) decodes the same through both
    packages' sharded decoders."""
    _cpus(monkeypatch, 4)
    raw = _fastq(np.random.default_rng(23), 250)
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    kw = dict(_SMALL, block_bytes=32768, use_model=1, qctx_k=4,
              qctx_hash_bits=14)
    t, j = str(tmp_path / "t.fqz"), str(tmp_path / "j.fqz")
    td.compress_se(CodecParams(**kw), str(src), t, device="cpu")
    jd.compress_se(JParams(**kw), str(src), j)
    assert open(t, "rb").read() == open(j, "rb").read()
    monkeypatch.setattr(td, "CTX_SHARD_MIN_ENTRIES", 1)
    monkeypatch.setattr(jd, "CTX_SHARD_MIN_ENTRIES", 1)
    calls = []
    plain = kernels.ctx_shard_decode_plain

    def spy(*a, **k):
        calls.append(len(a[4]))
        return plain(*a, **k)

    monkeypatch.setattr(kernels, "ctx_shard_decode_plain", spy)
    outs = td.decompress(j, str(tmp_path / "tb"), force=True, device="cpu",
                         mesh=4)
    assert open(outs[0], "rb").read() == raw
    assert calls and set(calls) == {4}
    jm._SHARD_DECODE_CACHE.clear()
    outs = jd.decompress(t, str(tmp_path / "jb"), force=True, mesh=4)
    assert open(outs[0], "rb").read() == raw
    assert len(jm._SHARD_DECODE_CACHE) >= 1


# --- refusals ----------------------------------------------------------------

def test_mesh2_refused_on_one_device(tmp_path):
    src = tmp_path / "in.fq"
    src.write_bytes(_fastq(np.random.default_rng(1), 20))
    with pytest.raises(ValueError,
                       match=r"^--mesh 2: only 1 device\(s\) visible$"):
        td.compress_se(CodecParams(mesh_n=2), str(src),
                       str(tmp_path / "x.fqz"), device="cpu")


def test_sharded_aligner_refuses_one_device(small_ref):
    _, _, tidx_, tp = _indexes(small_ref[0], 11)
    with pytest.raises(ValueError, match="mesh"):
        tsharded.ShardedAligner(tidx_, tp, kind="cpu")


def test_shard_ref_index_refuses_4g():
    class Big:
        ref_len = 1 << 32
    with pytest.raises(ValueError, match="u32 coordinates"):
        tm.shard_ref_index(Big(), 2)
    assert len(jax.devices()) == 8
