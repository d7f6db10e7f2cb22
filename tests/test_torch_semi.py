"""The semi-adaptive walk, adapting from frozen tables, the device trainer
and the library API of fastqueeze_tpu_torch against fastqueeze_tpu.

On the CPU the K11/K12/K13 wrappers take their plain PyTorch versions;
these tests hold them to the JAX engine on the same seeded inputs, bit
for bit: K11/K12 against _pass1_semi/_decode_semi (start, freq, final
counts, symbols) for chunks 16, 32 and 128, from init and from a trained
table; the stream payloads of encode_stream with adapt_chunk; the
fallback to the per-wave walk when the chunk does not divide T; a table
with zero counts; K13 against train_counts and the host trainer's
histogram; SE and PE archives with adapt_chunk=16, frozen_adapt and both,
decoded across packages; api and the CLI's -D.  The kernels themselves
are held to the plain versions on the card by tests/test_torch_gpu.py.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu import api as japi
from fastqueeze_tpu import cli as jcli
from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.models import base as jb
from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu.pipeline import driver as jd
from fastqueeze_tpu.pipeline import frozen as jf
from fastqueeze_tpu.pipeline import pe as jpe
from fastqueeze_tpu_torch import api, cli
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.container.arcfile import ArcReader
from fastqueeze_tpu_torch.models import base as tb
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import kernels as tk
from fastqueeze_tpu_torch.pipeline import driver as td
from fastqueeze_tpu_torch.pipeline import pe as tpe

_P = dict(lanes_min=8, lanes_max=64, lane_target_symbols=256)
_MODELS = {
    "seq_o6": ("SeqModel", dict(alphabet=4, init=3, inc=1, cap=253,
                                order=6)),
    "fqz_q2": ("QualModel", dict(alphabet=40, init=1, inc=8, cap=8192,
                                 qlevel=2)),
    "fqz_q3": ("QualModel", dict(alphabet=40, init=1, inc=8, cap=8192,
                                 qlevel=3)),
    "order1_byte": ("Order1ByteModel", dict(alphabet=256, init=1, inc=16,
                                            cap=8192)),
}


def _stream(name, seed, n_reads=300):
    """(jax model, port model, per-read counts with zero-length reads,
    symbols, a table trained by the JAX engine on other symbols)."""
    cls, kw = _MODELS[name]
    jm, tm = getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 90, n_reads).astype(np.int64)
    counts[::13] = 0
    n = int(counts.sum())

    def draw():
        if cls == "QualModel":      # random-walk ranks: repetitive contexts
            return np.clip(np.cumsum(rng.integers(-2, 3, n)) % 80 - 20, 0,
                           jm.alphabet - 1).astype(np.uint8)
        return rng.integers(0, jm.alphabet, n).astype(np.uint8)

    syms, train = draw(), draw()
    table = np.asarray(je.train_counts(jm, JParams(**_P), train, counts))
    return jm, tm, counts, syms, table


def _padded_words(words, emit):
    out, n = tk.compact_words(words, emit)
    k = int(n.item())
    W = 1024
    while W < k + 8:
        W <<= 1
    pad = torch.zeros(W, dtype=torch.int16)
    pad[:k] = out[:k]
    return pad


# qlevel 3's 2^20 x 40 table makes every JAX whole-table pass slow on the
# CPU: one chunk size there
_WALKS = [(name, chunk) for name in ("order1_byte", "fqz_q2", "seq_o6")
          for chunk in (16, 32, 128)] + [("fqz_q3", 128)]


@pytest.mark.parametrize("name,chunk", _WALKS)
def test_semi_walk_plain_matches_jax(name, chunk):
    """K11 (start, freq, final counts) against _pass1_semi and K12
    (symbols, final counts) against _decode_semi, from init and from a
    trained counts0."""
    jm, tm, counts, syms, table = _stream(name, 1)
    L = 64
    lay = te.make_layout(counts, L)
    T = lay.T
    assert T % chunk == 0 and T // chunk >= 2
    g = te.to_grid(lay, syms)
    cg = te._counts_grid(counts, L)
    valid, aux = je._device_aux(T, jnp.asarray(cg))
    ctx = je._ctx_grids(jm, jnp.asarray(g), aux)
    nh = je._n_halve_chunk(jm, L, chunk)
    assert te._n_halve_chunk(tm, L, chunk) == nh
    v = np.asarray(valid)
    gt, cgt = torch.from_numpy(g), torch.from_numpy(cg)
    for c0 in (None, table):
        jc0 = je.init_counts(jm) if c0 is None else jnp.asarray(c0)
        tc0 = None if c0 is None else torch.tensor(c0)
        start, freq, jcounts = je._pass1_semi(jm, nh, chunk, jc0, ctx,
                                              jnp.asarray(g), valid)
        sf, tcounts = tk.semi_encode_walk(gt, cgt, tm, nh, chunk, tc0)
        u = sf.numpy().view(np.uint32).astype(np.int64)
        assert np.array_equal((u & 0xFFFF)[v], np.asarray(start)[v])
        assert np.array_equal(((u >> 16) - (u & 0xFFFF))[v],
                              np.asarray(freq)[v])
        assert not u[~v].any()
        assert np.array_equal(tcounts.numpy(), np.asarray(jcounts))

        words, emit, states = tk.rans_encode_sf(sf, cgt)
        wpad = _padded_words(words, emit)
        jsyms, jdc, _ = je._decode_semi(
            jm, nh, chunk, jc0, jm.lane_init(L),
            jnp.asarray(states.numpy().view(np.uint32)),
            jnp.asarray(wpad.numpy().view(np.uint16)), valid, aux)
        tsyms, tdc = tk.semi_decode(states, wpad, cgt, T, tm, nh, chunk, tc0)
        assert np.array_equal(tsyms.numpy()[v], np.asarray(jsyms)[v])
        assert np.array_equal(tsyms.numpy()[v], g[v])
        assert not tsyms.numpy()[~v].any()
        assert np.array_equal(tdc.numpy(), np.asarray(jdc))
        assert np.array_equal(tdc.numpy(), tcounts.numpy())


@pytest.mark.parametrize("name", ["fqz_q2", "order1_byte", "seq_o6"])
def test_stream_payload_matches_jax(name):
    """encode_stream with adapt_chunk (K11 -> K7 -> K3) writes the JAX
    payload, from init and from counts0; each package decodes the
    other's."""
    jm, tm, counts, syms, table = _stream(name, 2)
    p, jp = CodecParams(adapt_chunk=32, **_P), JParams(adapt_chunk=32, **_P)
    for c0 in (None, table):
        want = je.encode_stream(jm, jp, syms, counts,
                                counts0=None if c0 is None
                                else jnp.asarray(c0))
        got = te.encode_stream(tm, p, syms, counts, counts0=c0, adapt=True,
                               device="cpu")
        assert got == want
        assert got != te.encode_stream(tm, CodecParams(**_P), syms, counts,
                                       counts0=c0, adapt=True, device="cpu")
        back = te.decode_stream(tm, p, want, counts, counts0=c0, adapt=True,
                                device="cpu")
        assert np.array_equal(back, syms)
        jback = je.decode_stream(jm, jp, got, counts,
                                 counts0=None if c0 is None
                                 else jnp.asarray(c0))
        assert np.array_equal(np.asarray(jback), syms)


def test_chunk_not_dividing_T_takes_the_per_wave_walk():
    """_chunk_of: adapt_chunk applies only when it divides T; otherwise
    both packages write the per-wave walk's payload."""
    jm, tm, counts, syms, table = _stream("fqz_q2", 3)
    T = te.make_layout(counts, CodecParams(**_P).n_lanes(int(counts.sum()))).T
    assert T % 256
    per_wave = te.encode_stream(tm, CodecParams(**_P), syms, counts,
                                counts0=table, adapt=True, device="cpu")
    got = te.encode_stream(tm, CodecParams(adapt_chunk=256, **_P), syms,
                           counts, counts0=table, adapt=True, device="cpu")
    want = je.encode_stream(jm, JParams(adapt_chunk=256, **_P), syms, counts,
                            counts0=jnp.asarray(table))
    assert got == want == per_wave
    back = te.decode_stream(tm, CodecParams(adapt_chunk=256, **_P), got,
                            counts, counts0=table, adapt=True, device="cpu")
    assert np.array_equal(back, syms)


def test_flat_model_streams_keep_the_per_wave_walk():
    """Streams with caller-supplied contexts (FlatModel) run K5/K6 even
    with adapt_chunk set, as the reference's unfused path does."""
    rng = np.random.default_rng(4)
    kw = dict(alphabet=256, init=1, inc=16, cap=8192, n_ctx=4)
    jm, tm = jb.FlatModel(**kw), tb.FlatModel(**kw)
    counts = np.full(64, 128, np.int64)
    syms = rng.integers(0, 256, int(counts.sum())).astype(np.uint8)
    aux = {"ctx": rng.integers(0, 4, len(syms)).astype(np.uint8)}
    want = je.encode_stream(jm, JParams(adapt_chunk=128, **_P), syms, counts,
                            extra_aux=aux)
    got = te.encode_stream(tm, CodecParams(adapt_chunk=128, **_P), syms,
                           counts, adapt=True, device="cpu", extra_aux=aux)
    assert got == want == te.encode_stream(
        tm, CodecParams(**_P), syms, counts, adapt=True, device="cpu",
        extra_aux=aux)


def test_zero_count_table_decodes_as_jax():
    """A counts0 with zero counts (a table trained with init 0): zero
    frequencies in the snapshot, which K12's plain version (the binary
    search, step for step from _decode_semi) resolves as the reference
    does; the kernel's count search is held to that search on such rows
    in tests/test_torch_semi_cluster.py."""
    kw = dict(alphabet=4, init=0, inc=1, cap=253, order=4)
    jm, tm = jb.SeqModel(**kw), tb.SeqModel(**kw)
    rng = np.random.default_rng(5)
    counts = rng.integers(20, 90, 200).astype(np.int64)
    syms = rng.integers(0, 3, int(counts.sum())).astype(np.uint8)
    table = np.asarray(je.train_counts(jm, JParams(**_P), syms, counts))
    assert (table == 0).any() and (table.sum(axis=1) > 0).any()
    use = jb.SeqModel(alphabet=4, init=3, inc=1, cap=253, order=4)
    tuse = tb.SeqModel(alphabet=4, init=3, inc=1, cap=253, order=4)
    jp, p = JParams(adapt_chunk=128, **_P), CodecParams(adapt_chunk=128, **_P)
    want = je.encode_stream(use, jp, syms, counts, counts0=jnp.asarray(table))
    assert te.encode_stream(tuse, p, syms, counts, counts0=table, adapt=True,
                            device="cpu") == want
    back = te.decode_stream(tuse, p, want, counts, counts0=table, adapt=True,
                            device="cpu")
    assert np.array_equal(back, syms)


def test_overcap_counts0_rows_raise_on_the_per_wave_walk():
    """K5/K6 skip padding lanes, exact only while every counts0 row starts
    at or under cap: a table with a row over cap is refused; the
    semi-adaptive walk halves every row and takes it."""
    jm, tm, counts, syms, table = _stream("seq_o6", 6)
    big = table.copy()
    big[3] = 200
    with pytest.raises(ValueError, match="cap"):
        te.encode_stream(tm, CodecParams(**_P), syms, counts, counts0=big,
                         adapt=True, device="cpu")
    p, jp = CodecParams(adapt_chunk=128, **_P), JParams(adapt_chunk=128, **_P)
    assert te.encode_stream(tm, p, syms, counts, counts0=big, adapt=True,
                            device="cpu") == je.encode_stream(
        jm, jp, syms, counts, counts0=jnp.asarray(big))


# --- K13: the trainer --------------------------------------------------------

_TRAIN = {
    "seq_o6": ("SeqModel", dict(alphabet=4, init=3, inc=1, cap=253,
                                order=6)),
    "fqz_q2": ("QualModel", dict(alphabet=40, init=1, inc=8, cap=8192,
                                 qlevel=2)),
    "chain_k4_hash": ("QualModel", dict(alphabet=8, init=1, inc=16, cap=8192,
                                        k=4, ctx_base=7, hash_bits=12,
                                        pos_bits=3, drop_bits=2)),
}


@pytest.mark.parametrize("name", sorted(_TRAIN))
def test_train_counts_matches_jax_and_host_trainer(name):
    """te.train_counts (K13's plain version) == je.train_counts == the
    host trainer's bincount histogram + cap rescale (frozen._hist_counts)
    over the same contexts."""
    cls, kw = _TRAIN[name]
    jm, tm = getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)
    rng = np.random.default_rng(7)
    lengths = rng.integers(1, 150, 400).astype(np.int64)
    n = int(lengths.sum())
    if cls == "SeqModel":
        syms = rng.integers(0, 4, n).astype(np.uint8)
        ctx = jf.seq_ctx_flat(jm, syms, lengths)
    else:
        syms = np.clip(np.cumsum(rng.integers(-1, 2, n)) % 30, 0,
                       jm.alphabet - 1).astype(np.uint8)
        ctx = jf.qual_ctx_flat(jm, syms, lengths)
    want = np.asarray(je.train_counts(jm, JParams(**_P), syms, lengths))
    got = te.train_counts(tm, CodecParams(**_P), syms, lengths, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, jf._hist_counts(jm, ctx, syms))
    assert (got.numpy().sum(axis=1) <= jm.cap).all()


def test_train_counts_flat_model_matches_jax():
    rng = np.random.default_rng(8)
    kw = dict(alphabet=256, init=1, inc=16, cap=8192, n_ctx=4)
    jm, tm = jb.FlatModel(**kw), tb.FlatModel(**kw)
    counts = rng.integers(0, 200, 100).astype(np.int64)
    syms = rng.integers(0, 256, int(counts.sum())).astype(np.uint8)
    aux = {"ctx": rng.integers(0, 4, len(syms)).astype(np.uint8)}
    want = np.asarray(je.train_counts(jm, JParams(**_P), syms, counts,
                                      extra_aux=aux))
    got = te.train_counts(tm, CodecParams(**_P), syms, counts,
                          extra_aux=aux, device="cpu")
    assert np.array_equal(got.numpy(), want)


# --- archives ------------------------------------------------------------------

_ARCH = {
    "chunk16": dict(adapt_chunk=16),
    "frozen_adapt": dict(use_model=1, frozen_adapt=1),
    "frozen_adapt_chunk16": dict(use_model=1, frozen_adapt=1, adapt_chunk=16),
}
# 512-ish lanes keep T small, so the JAX semi walk's whole-table passes
# stay few on the CPU
_LANES = dict(lanes_min=256, lane_target_symbols=128)


def _reads(rng, n, mate=0):
    """n seeded reads of 40-120 bp, a few N bases, random-walk qualities
    over four bins, SRA-style IDs."""
    bins = np.array([2, 12, 24, 37])
    recs = []
    for r in range(n):
        L = int(rng.integers(40, 121))
        seq = bytearray(b"ACGT"[c] for c in rng.integers(0, 4, L))
        if r % 19 == mate:
            seq[L // 2] = ord("N")
        walk = np.clip(np.cumsum(rng.integers(-1, 2, L)) + 2, 0, 3)
        recs.append(b"@SRR0000001.%d %d length=%d\n" % (r + 1, r + 1, L)
                    + bytes(seq) + b"\n+\n"
                    + bytes((bins[walk] + 33).astype(np.uint8)) + b"\n")
    return b"".join(recs)


@pytest.fixture(scope="module")
def semi_archives(tmp_path_factory):
    """{(kind, config): (inputs, JAX archive, port archive)} for SE (1,000
    reads) and PE (500 pairs)."""
    d = tmp_path_factory.mktemp("torch_semi")
    rng = np.random.default_rng(9)
    se = [str(d / "se.fq")]
    pe = [str(d / "pe_1.fq"), str(d / "pe_2.fq")]
    with open(se[0], "wb") as fh:
        fh.write(_reads(rng, 1000))
    for k, path in enumerate(pe):
        with open(path, "wb") as fh:
            fh.write(_reads(rng, 500, mate=k))
    out = {}
    for name, kw in _ARCH.items():
        for kind, ins in (("se", se), ("pe", pe)):
            ja, ta = str(d / f"j_{kind}_{name}.fqz"), str(d / f"t_{kind}_"
                                                         f"{name}.fqz")
            if kind == "se":
                jd.compress_se(JParams(**kw, **_LANES), ins[0], ja)
                td.compress_se(CodecParams(**kw, **_LANES), ins[0], ta,
                               device="cpu")
            else:
                jpe.compress_pe(JParams(**kw, **_LANES), *ins, ja)
                tpe.compress_pe(CodecParams(**kw, **_LANES), *ins, ta,
                                device="cpu")
            out[kind, name] = (ins, ja, ta)
    return out


@pytest.mark.parametrize("kind", ["se", "pe"])
@pytest.mark.parametrize("name", sorted(_ARCH))
def test_archive_bytes_equal(semi_archives, kind, name):
    ins, ja, ta = semi_archives[kind, name]
    with open(ja, "rb") as a, open(ta, "rb") as b:
        assert a.read() == b.read()
    with ArcReader(ta) as r:
        assert (r.model_blob is not None) == name.startswith("frozen")
        assert r.params.adapt_chunk == _ARCH[name].get("adapt_chunk", 0)
        assert r.params.frozen_adapt == _ARCH[name].get("frozen_adapt", 0)


@pytest.mark.parametrize("kind", ["se", "pe"])
@pytest.mark.parametrize("name", sorted(_ARCH))
def test_archive_cross_decode(semi_archives, kind, name, tmp_path):
    ins, ja, ta = semi_archives[kind, name]
    raws = [open(p, "rb").read() for p in ins]
    td.decompress(ja, str(tmp_path / "t"), force=True, device="cpu")
    jd.decompress(ta, str(tmp_path / "j"), force=True)
    for out in ("t", "j"):
        names = ([f"{out}.fastq"] if kind == "se"
                 else [f"{out}_1.fastq", f"{out}_2.fastq"])
        for raw, f in zip(raws, names):
            with open(tmp_path / f, "rb") as fh:
                assert fh.read() == raw, (out, f)


# --- the library API and -D ------------------------------------------------------

def test_api_matches_the_cli_archive(tmp_path, monkeypatch):
    """api.compress with CodecParams(adapt_chunk=16) writes the archive the
    (JAX package's) CLI writes with AdaptChunk:16 in the config file that
    the port's -D dumped; api.decompress restores it; describe matches the
    JAX api's."""
    monkeypatch.chdir(tmp_path)
    fq = str(tmp_path / "in.fq")
    with open(fq, "wb") as fh:
        fh.write(_reads(np.random.default_rng(10), 300))
    assert cli.main(["-D"]) == 0
    conf = (tmp_path / "fastqueeze.config").read_text()
    assert "AdaptChunk:0\n" in conf
    (tmp_path / "fastqueeze.config").write_text(
        conf.replace("AdaptChunk:0\n", "AdaptChunk:16\n"))
    assert jcli.main(["-c", "-1", fq, "-o", str(tmp_path / "cli.fqz"),
                      "-f"]) == 0
    stats = api.compress(fq, str(tmp_path / "api.fqz"),
                         params=CodecParams(adapt_chunk=16), device="cpu")
    assert stats["compressed"] == os.path.getsize(tmp_path / "api.fqz")
    want = (tmp_path / "cli.fqz").read_bytes()
    assert (tmp_path / "api.fqz").read_bytes() == want
    out = api.decompress(str(tmp_path / "cli.fqz"), str(tmp_path / "back"),
                         device="cpu")
    assert open(out[0], "rb").read() == open(fq, "rb").read()
    got, ref = (api.describe(str(tmp_path / "api.fqz")),
                japi.describe(str(tmp_path / "cli.fqz")))
    assert dataclasses.asdict(got.pop("params")) == dataclasses.asdict(
        ref.pop("params"))
    assert got == ref


def test_api_refusals_name_their_roadmap_item(tmp_path):
    """merge, extract, part and 3+ inputs, once refused with Queue A item
    4, now do what the JAX api does (same archives, same files); mesh 2
    on one device is still refused, and lossy writes the JAX archive."""
    fq = str(tmp_path / "in.fq")
    arc = str(tmp_path / "x.fqz")
    with pytest.raises(ValueError, match=r"--mesh 2: only 1 device\(s\)"):
        api.compress(fq, arc, mesh=2, device="cpu")
    with open(fq, "wb") as fh:
        fh.write(_reads(np.random.default_rng(12), 300))
    api.compress(fq, arc, lossy=2.0, device="cpu")
    japi.compress(fq, str(tmp_path / "j.fqz"), lossy=2.0)
    assert open(arc, "rb").read() == (tmp_path / "j.fqz").read_bytes()
    p = dict(block_bytes=20_000)
    for k in (0, 1):
        api.compress(fq, str(tmp_path / f"t{k}.fqz"), part=(k, 2),
                     params=CodecParams(**p), device="cpu")
        japi.compress(fq, str(tmp_path / f"j{k}.fqz"), part=(k, 2),
                      params=JParams(**p))
    api.merge(str(tmp_path / "tm.fqz"), [str(tmp_path / "t0.fqz"),
                                         str(tmp_path / "j1.fqz")])
    japi.merge(str(tmp_path / "jm.fqz"), [str(tmp_path / "j0.fqz"),
                                          str(tmp_path / "t1.fqz")])
    single = str(tmp_path / "single.fqz")
    japi.compress(fq, single, params=JParams(**p))
    for m in ("tm", "jm"):
        assert (tmp_path / f"{m}.fqz").read_bytes() == open(single,
                                                            "rb").read()
    outs = [api.extract(single, 10, 3, str(tmp_path / "xt"), device="cpu"),
            japi.extract(single, 10, 3, str(tmp_path / "xj"))]
    assert open(outs[0][0], "rb").read() == open(outs[1][0], "rb").read()
    api.compress([fq, fq, fq], str(tmp_path / "mt.fqz"), device="cpu")
    japi.compress([fq, fq, fq], str(tmp_path / "mj.fqz"))
    assert ((tmp_path / "mt.fqz").read_bytes()
            == (tmp_path / "mj.fqz").read_bytes())
    for call in (lambda: api.compress([fq, fq, fq], arc, part=(0, 2),
                                      device="cpu"),
                 lambda: japi.compress([fq, fq, fq], arc, part=(0, 2))):
        with pytest.raises(ValueError, match="part is not supported with "
                           "multi-file archives"):
            call()


def test_cli_dump_config_equals_jax(tmp_path, monkeypatch):
    for sub, main in (("t", cli.main), ("j", jcli.main)):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert main(["-D"]) == 0
    a = (tmp_path / "t" / "fastqueeze.config").read_bytes()
    assert a == (tmp_path / "j" / "fastqueeze.config").read_bytes()
    assert b"AdaptChunk:0\n" in a
