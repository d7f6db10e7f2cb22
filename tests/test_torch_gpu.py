"""CUDA kernels of fastqueeze_tpu_torch against their plain PyTorch versions.

These run only on a machine with a CUDA card (they skip elsewhere):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(--noconftest: tests/conftest.py sets up JAX, which these tests do not
use.)  Integer kernels, so every comparison is bit-exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.models.base import (
    CtxModel, FlatModel, Order1ByteModel, QualModel, SeqModel)
from fastqueeze_tpu_torch.ops import engine, kernels
from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid

pytestmark = pytest.mark.gpu

_MODELS = [
    SeqModel(alphabet=4, order=10),
    QualModel(alphabet=48, qlevel=2),
    QualModel(alphabet=8, k=4, ctx_base=7, hash_bits=16, pos_bits=3),
    QualModel(alphabet=16, k=6, ctx_base=12, hash_bits=18, drop_bits=2),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda", torch.cuda.current_device())


def _stream(rng, model, R, L, maxlen):
    counts = rng.integers(0, maxlen, R).astype(np.int64)
    counts[::11] = 0
    lay = make_layout(counts, L)
    syms = rng.integers(0, model.alphabet, int(counts.sum())).astype(np.uint8)
    table = rng.integers(1, 40, (model.n_ctx, model.alphabet)).astype(np.int32)
    return counts, lay, syms, table


@pytest.mark.parametrize("model", _MODELS, ids=lambda m: type(m).__name__)
def test_kernels_match_plain(cuda, model):
    rng = np.random.default_rng(7)
    counts, lay, syms, table = _stream(rng, model, R=3000, L=256, maxlen=90)
    c_cpu = torch.from_numpy(table)
    cum_p, packed_p = kernels.quant_pack(c_cpu)
    cum, packed = kernels.quant_pack(c_cpu.to(cuda))
    assert torch.equal(cum.cpu(), cum_p) and torch.equal(packed.cpu(),
                                                         packed_p)

    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(engine._counts_grid(counts, lay.L))
    want = kernels.frozen_encode_lanes(g, cg, packed_p, model)
    got = kernels.frozen_encode_lanes(g.to(cuda), cg.to(cuda), packed, model)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)

    out_p, n_p = kernels.compact_words(*want[:2])
    out, n = kernels.compact_words(*got[:2])
    k = int(n_p.item())
    assert int(n.item()) == k
    assert torch.equal(out[:k].cpu(), out_p[:k])

    W = 1024
    while W < k + 8:
        W <<= 1
    words = torch.zeros(W, dtype=torch.int16)
    words[:k] = out_p[:k]
    dec_p = kernels.frozen_decode(want[2], words, cg, lay.T, cum_p, model)
    dec = kernels.frozen_decode(got[2], words.to(cuda), cg.to(cuda), lay.T,
                                cum, model)
    assert torch.equal(dec.cpu(), dec_p)


@pytest.mark.parametrize("L", [64, 1000, 5000, 1 << 16])
def test_decode_any_lane_count(cuda, L):
    """K4 takes any L up to the format's 2^16: fewer lanes than threads, a
    ragged last thread, several (up to 64) lanes per thread."""
    rng = np.random.default_rng(L)
    model = QualModel(alphabet=8, k=3, ctx_base=8, pos_bits=2)
    counts, lay, syms, table = _stream(rng, model, R=3 * L, L=L, maxlen=40)
    p = CodecParams()
    pay = engine.encode_stream(model, p, syms, counts, counts0=table,
                               n_lanes=L, device="cpu")
    pay_dev = engine.encode_stream(model, p, syms, counts, counts0=table,
                                   n_lanes=L, device=cuda)
    assert pay_dev == pay
    back = engine.decode_stream(model, p, pay, counts, counts0=table,
                                device=cuda)
    assert np.array_equal(back, syms)


def test_corrupt_words_stay_in_bounds(cuda):
    """A payload whose word count is cut decodes (garbage, no fault):
    renorm reads clamp to the padded buffer as the plain version does."""
    rng = np.random.default_rng(3)
    model = SeqModel(alphabet=4, order=6)
    counts, lay, syms, table = _stream(rng, model, R=500, L=64, maxlen=60)
    p = CodecParams()
    pay = bytearray(engine.encode_stream(model, p, syms, counts,
                                         counts0=table, n_lanes=64,
                                         device="cpu"))
    n_words = int.from_bytes(pay[8:12], "little")
    pay[8:12] = (n_words // 3).to_bytes(4, "little")
    pay = bytes(pay[:16 + 4 * 64 + 2 * (n_words // 3)])
    want = engine.decode_stream(model, p, pay, counts, counts0=table,
                                device="cpu")
    got = engine.decode_stream(model, p, pay, counts, counts0=table,
                               device=cuda)
    torch.cuda.synchronize()
    assert np.array_equal(got, want)


def test_wrappers_raise_on_bad_input(cuda):
    with pytest.raises(ValueError):
        kernels.quant_pack(torch.ones((4, 4), dtype=torch.int64,
                                      device=cuda))
    with pytest.raises(ValueError):
        kernels.compact_words(torch.zeros((4, 4), dtype=torch.int16),
                              torch.zeros((4, 4), dtype=torch.uint8,
                                          device=cuda))


def _host_oracle(model, p, syms, counts, table):
    """Payload from the native host coder (bit-identical to fastqueeze_tpu's
    device path), or skip when the native library is unavailable."""
    from fastqueeze_tpu_torch.io import native
    from fastqueeze_tpu_torch.ops import host_frozen
    if native.get_lib() is None:
        pytest.skip("native library unavailable (make -C native)")
    cum = host_frozen.quantize(table)
    return host_frozen.encode_job(model, p, syms, counts, cum).finalize()


@pytest.mark.parametrize("shape", ["ragged_long_read", "empty_stream"])
def test_payload_matches_native_oracle(cuda, shape):
    """K1-K4 through the engine vs the native coder: zero-length reads,
    one read longer than 65,536 bases (exact positions), and a stream
    with no symbols at all."""
    rng = np.random.default_rng(9)
    model = QualModel(alphabet=8, k=2, ctx_base=8, drop_bits=2, pos_bits=3)
    if shape == "empty_stream":
        counts = np.zeros(5, np.int64)
    else:
        counts = rng.integers(0, 200, 300).astype(np.int64)
        counts[::9] = 0
        counts[7] = 70_000
    syms = rng.integers(0, 8, int(counts.sum())).astype(np.uint8)
    table = rng.integers(1, 300, (model.n_ctx, 8)).astype(np.int32)
    p = CodecParams(lanes_min=8, lanes_max=64, lane_target_symbols=512)
    want = _host_oracle(model, p, syms, counts, table)
    got = engine.encode_stream(model, p, syms, counts, counts0=table,
                               device=cuda)
    assert got == want
    back = engine.decode_stream(model, p, want, counts, counts0=table,
                                device=cuda)
    assert np.array_equal(back, syms)


def test_pipeline_on_card_matches_host_route(cuda, tmp_path, monkeypatch):
    """compress_se on the card == the native-host-routed archive, on
    variable-length reads with N bases and duplicates; decodes on the
    card byte for byte."""
    from fastqueeze_tpu_torch.pipeline import driver
    rng = np.random.default_rng(21)
    recs = []
    for r in range(3000):
        n = int(rng.integers(20, 160))
        seq = bytearray(rng.choice(list(b"ACGT"), n).astype(np.uint8))
        if r % 13 == 0:
            seq[n // 2] = ord("N")
        qual = (np.clip(np.cumsum(rng.integers(-2, 3, n)) + 30, 2, 41)
                + 33).astype(np.uint8)
        recs.append(b"@read.%d\n%s\n+\n%s\n" % (r, bytes(seq), bytes(qual)))
    recs[50] = recs[20]
    fq = tmp_path / "in.fq"
    fq.write_bytes(b"".join(recs))
    arcs = {}
    for mode in ("device", "host"):
        monkeypatch.setenv("FASTQUEEZE_FROZEN_EXEC", mode)
        arcs[mode] = str(tmp_path / f"{mode}.fqz")
        driver.compress_se(CodecParams(use_model=1, block_bytes=60000),
                           str(fq), arcs[mode], device=cuda)
    with open(arcs["device"], "rb") as a, open(arcs["host"], "rb") as b:
        assert a.read() == b.read()
    monkeypatch.setenv("FASTQUEEZE_FROZEN_EXEC", "device")
    kernels.reset_launch_counts()
    out = driver.decompress(arcs["host"], str(tmp_path / "back"),
                            force=True, device=cuda)
    assert kernels.LAUNCHES["frozen_decode"] > 0
    assert open(out[0], "rb").read() == fq.read_bytes()


# --- adaptive coder: K5 adapt_encode_walk, K7 rans_encode_sf, K6 ---------

_ADAPT = {
    "seq_o10": SeqModel(alphabet=4, init=3, inc=1, cap=253, order=10),
    "fqz_q2": QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=2),
    "fqz_q3": QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=3),
    "chain_k4": QualModel(alphabet=8, init=1, inc=16, cap=8192, k=4,
                          ctx_base=7, hash_bits=12, pos_bits=3),
    "order1_byte": Order1ByteModel(alphabet=256, init=1, inc=16, cap=8192),
    "order0_flag": CtxModel(alphabet=2, init=1, inc=16, cap=8192),
    "flat_4": FlatModel(alphabet=256, init=1, inc=16, cap=8192, n_ctx=4),
}


def _adapt_roundtrip(cuda, model, counts, syms, L, ctx=None, counts0=None):
    """K5 -> K7 -> K3 -> K6 on the card against the plain versions on the
    same inputs (from a fresh table or from counts0); returns the card's
    decoded grid and the input grid."""
    lay = make_layout(counts, L)
    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(engine._counts_grid(counts, L))
    cx = (None if ctx is None
          else torch.from_numpy(to_grid(lay, ctx.astype(np.int32))))
    c0 = None if counts0 is None else torch.from_numpy(counts0)
    on = (lambda t: None if t is None else t.to(cuda))
    nh = engine._n_halve(model, L)
    sf_p = kernels.adapt_encode_walk(g, cg, model, nh, cx, c0)
    sf = kernels.adapt_encode_walk(on(g), on(cg), model, nh, on(cx), on(c0))
    assert torch.equal(sf.cpu(), sf_p)
    enc_p = kernels.rans_encode_sf(sf_p, cg)
    enc = kernels.rans_encode_sf(sf, on(cg))
    for a, b in zip(enc, enc_p):
        assert torch.equal(a.cpu(), b)
    out, n = kernels.compact_words(*enc[:2])
    k = int(n.item())
    W = 1024
    while W < k + 8:
        W <<= 1
    words = torch.zeros(W, dtype=torch.int16)
    words[:k] = out[:k].cpu()
    dec_p = kernels.adapt_decode(enc_p[2], words, cg, lay.T, model, nh, cx,
                                 c0)
    dec = kernels.adapt_decode(enc[2], on(words), on(cg), lay.T, model, nh,
                               on(cx), on(c0))
    torch.cuda.synchronize()
    assert torch.equal(dec.cpu(), dec_p)
    return dec.cpu(), g


@pytest.mark.parametrize("name", sorted(_ADAPT))
def test_adaptive_kernels_match_plain(cuda, name):
    model = _ADAPT[name]
    rng = np.random.default_rng(len(name))
    counts = rng.integers(0, 120, 1500).astype(np.int64)
    counts[::11] = 0
    syms = rng.integers(0, model.alphabet, int(counts.sum())).astype(np.uint8)
    ctx = (rng.integers(0, model.n_ctx, len(syms))
           if isinstance(model, FlatModel) else None)
    kernels.reset_launch_counts()
    dec, g = _adapt_roundtrip(cuda, model, counts, syms, 256, ctx)
    assert torch.equal(dec, g)
    for k in ("adapt_encode_walk", "rans_encode_sf", "adapt_decode"):
        assert kernels.LAUNCHES[k] == 1, k


@pytest.mark.parametrize("L", [64, 1024, 4096])
def test_adaptive_duplicate_heavy_waves(cuda, L):
    """Every lane on one context in every wave: equal-length reads of one
    repeated base start together on the seq magic context, so each wave
    adds L increments to a single row and halves it n_halve times."""
    model = SeqModel(alphabet=4, init=3, inc=1, cap=253, order=10)
    counts = np.full(3 * L, 100, np.int64)
    syms = np.zeros(int(counts.sum()), np.uint8)
    syms[::7] = 2
    dec, g = _adapt_roundtrip(cuda, model, counts, syms, L)
    assert torch.equal(dec, g)


@pytest.mark.parametrize("L", [1, 33, 255, 256, 257, 2048, 4096, 4097,
                               8192])
def test_adapt_decode_cluster_edges(cuda, L):
    """K6 at lane counts on either side of a warp, a CTA of the one-lane
    cluster (512), its whole (8 x 512) and the several-lanes variant, on a
    byte model (A = 256: rows searched in batches) whose cap halves every
    touched row, so every wave halves; K5 and K6 launch once each."""
    model = Order1ByteModel(alphabet=256, init=1, inc=300, cap=512)
    assert model.alphabet + model.inc > model.cap
    rng = np.random.default_rng(L)
    counts = rng.integers(0, 30, 2 * L + 1).astype(np.int64)
    counts[::5] = 0
    syms = rng.integers(0, 256, int(counts.sum())).astype(np.uint8)
    syms[rng.random(len(syms)) < 0.5] = 65       # hot rows and symbols
    kernels.reset_launch_counts()
    dec, g = _adapt_roundtrip(cuda, model, counts, syms, L)
    assert torch.equal(dec, g)
    assert kernels.LAUNCHES["adapt_encode_walk"] == 1
    assert kernels.LAUNCHES["adapt_decode"] == 1


def _counts0(model, seed):
    rng = np.random.default_rng(seed)
    per = max(1, model.cap // model.alphabet)
    return rng.integers(1, per + 1, (model.n_ctx, model.alphabet)).astype(
        np.int32)


@pytest.mark.parametrize("from_table", [False, True])
@pytest.mark.parametrize("name", ["order0_flag", "seq_o10", "fqz_q2"])
def test_adapt_encode_heavy_row(cuda, name, from_table):
    """K5's warp walk on rows with events in every wave: the order-0 model
    (one row takes every event), seq reads of one repeated base (most
    events of every wave on the all-zero history) and qualities stuck on
    one value, from a fresh table and from counts0."""
    model = _ADAPT[name]
    rng = np.random.default_rng(3)
    counts = rng.integers(20, 300, 3000).astype(np.int64)
    syms = (rng.integers(0, model.alphabet, int(counts.sum())) if
            name == "order0_flag" else np.zeros(int(counts.sum()), np.int64))
    syms[::97] = model.alphabet - 1
    c0 = _counts0(model, 4) if from_table else None
    kernels.reset_launch_counts()
    dec, g = _adapt_roundtrip(cuda, model, counts, syms.astype(np.uint8),
                              1024, counts0=c0)
    assert torch.equal(dec, g)
    assert kernels.LAUNCHES["adapt_encode_walk"] == 1
    assert kernels.LAUNCHES["adapt_decode"] == 1


@pytest.mark.parametrize("shape", ["ragged", "empty_stream"])
def test_adaptive_engine_on_card_matches_cpu(cuda, shape):
    """The adaptive engine's payload on the card equals the plain
    versions' on the CPU and the native coder's; it decodes on the card."""
    from fastqueeze_tpu_torch.ops import host_adapt
    rng = np.random.default_rng(12)
    model = QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=2)
    counts = rng.integers(0, 150, 900).astype(np.int64)
    counts[::9] = 0
    if shape == "empty_stream":
        counts[:] = 0
    syms = rng.integers(0, 40, int(counts.sum())).astype(np.uint8)
    p = CodecParams()
    want = engine.encode_stream(model, p, syms, counts, adapt=True,
                                device="cpu")
    got = engine.encode_stream(model, p, syms, counts, adapt=True,
                               device=cuda)
    assert got == want
    job = host_adapt.encode_job(model, p, syms, counts)
    if job is not None:
        assert job.finalize() == want
    back = engine.decode_stream(model, p, want, counts, adapt=True,
                                device=cuda)
    assert np.array_equal(back, syms)


def test_adaptive_pipeline_on_card_matches_host_route(cuda, tmp_path,
                                                      monkeypatch):
    """compress_se below the usemodel gate on the card == the archive
    with FASTQUEEZE_ADAPT_EXEC=host (native seq/qual coder); with
    host_stream_max=0 every length, flag and ID stream takes marker 1 on
    the card too; both decode on the card."""
    from fastqueeze_tpu_torch.ops import host_adapt
    from fastqueeze_tpu_torch.pipeline import driver
    rng = np.random.default_rng(31)
    recs = []
    for r in range(2000):
        n = int(rng.integers(30, 151))
        seq = bytearray(rng.choice(list(b"ACGT"), n).astype(np.uint8))
        if r % 17 == 0:
            seq[n // 3] = ord("N")
        qual = (np.clip(np.cumsum(rng.integers(-2, 3, n)) + 30, 2, 41)
                + 33).astype(np.uint8)
        recs.append(b"@A00123:45:HXXXXDSXX:1:%d:%d:%d 1:N:0:ACGTACGT\n"
                    b"%s\n+\n%s\n" % (1101 + r // 500,
                                       int(rng.integers(1000, 32000)),
                                       int(rng.integers(1000, 32000)),
                                       bytes(seq), bytes(qual)))
    recs[90] = recs[30]
    fq = tmp_path / "in.fq"
    fq.write_bytes(b"".join(recs))
    for kw in (dict(), dict(qlevel=3), dict(host_stream_max=0)):
        arcs = {}
        for mode in ("device", "host"):
            monkeypatch.setenv("FASTQUEEZE_ADAPT_EXEC", mode)
            arcs[mode] = str(tmp_path / f"{mode}.fqz")
            host_adapt.NATIVE_CALLS["encode"] = 0
            kernels.reset_launch_counts()
            driver.compress_se(CodecParams(**kw), str(fq), arcs[mode],
                               device=cuda)
            if mode == "device":
                assert host_adapt.NATIVE_CALLS["encode"] == 0
                assert kernels.LAUNCHES["adapt_encode_walk"] >= 2
        with open(arcs["device"], "rb") as a, open(arcs["host"], "rb") as b:
            assert a.read() == b.read(), kw
        monkeypatch.setenv("FASTQUEEZE_ADAPT_EXEC", "device")
        out = driver.decompress(arcs["host"], str(tmp_path / "back"),
                                force=True, device=cuda)
        assert open(out[0], "rb").read() == fq.read_bytes(), kw


# --- semi-adaptive walk: K11, K12; trainer: K13 -----------------------------

_SEMI = {
    "seq_o10": SeqModel(alphabet=4, init=3, inc=1, cap=253, order=10),
    "fqz_q3": QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=3),
    "order1_byte": Order1ByteModel(alphabet=256, init=1, inc=16, cap=8192),
}


def _semi_stream(rng, model, shape):
    """(counts, L, chunk): "ragged" = variable reads, zero-length ones and
    a long last read, chunk 64; "chunk_is_T" = one chunk of every wave."""
    if shape == "ragged":
        counts = rng.integers(0, 120, 1500).astype(np.int64)
        counts[::11] = 0
        counts[-1] = 900
        return counts, 256, 64
    counts = np.full(700, 100, np.int64)
    return counts, 64, make_layout(counts, 64).T


@pytest.mark.parametrize("shape", ["ragged", "chunk_is_T"])
@pytest.mark.parametrize("name", sorted(_SEMI))
def test_semi_kernels_match_plain(cuda, name, shape):
    """K11 -> K7 -> K3 -> K12 on the card against the plain versions on
    the same inputs, from init and from a table trained by K13; the
    decode inverts the encode and the final counts agree."""
    model = _SEMI[name]
    rng = np.random.default_rng(len(name) + len(shape))
    counts, L, chunk = _semi_stream(rng, model, shape)
    lay = make_layout(counts, L)
    assert lay.T % chunk == 0
    syms = rng.integers(0, model.alphabet, int(counts.sum())).astype(np.uint8)
    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(engine._counts_grid(counts, L))
    trained = kernels.train_counts(g.flip(0).contiguous().to(cuda),
                                   cg.to(cuda), model)
    nh = engine._n_halve_chunk(model, L, chunk)
    kernels.reset_launch_counts()
    for c0 in (None, trained):
        c0_p = None if c0 is None else c0.cpu()
        sf_p, cnt_p = kernels.semi_encode_walk(g, cg, model, nh, chunk, c0_p)
        sf, cnt = kernels.semi_encode_walk(g.to(cuda), cg.to(cuda), model,
                                           nh, chunk, c0)
        assert torch.equal(sf.cpu(), sf_p) and torch.equal(cnt.cpu(), cnt_p)
        enc = kernels.rans_encode_sf(sf, cg.to(cuda))
        out, n = kernels.compact_words(*enc[:2])
        k = int(n.item())
        W = 1024
        while W < k + 8:
            W <<= 1
        words = torch.zeros(W, dtype=torch.int16)
        words[:k] = out[:k].cpu()
        dec_p, dc_p = kernels.semi_decode(enc[2].cpu(), words, cg, lay.T,
                                          model, nh, chunk, c0_p)
        dec, dc = kernels.semi_decode(enc[2], words.to(cuda), cg.to(cuda),
                                      lay.T, model, nh, chunk, c0)
        torch.cuda.synchronize()
        assert torch.equal(dec.cpu(), dec_p) and torch.equal(dc.cpu(), dc_p)
        assert torch.equal(dec.cpu(), g)
        assert torch.equal(dc_p, cnt_p)
    assert kernels.LAUNCHES["semi_encode_walk"] == 2
    assert kernels.LAUNCHES["semi_decode"] == 2


_TRAIN = {
    "seq_o10": SeqModel(alphabet=4, init=3, inc=1, cap=253, order=10),
    "fqz_q2": QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=2),
    "chain_k4_hash": QualModel(alphabet=8, init=1, inc=16, cap=8192, k=4,
                               ctx_base=7, hash_bits=16, pos_bits=3,
                               drop_bits=2),
    "flat_4": FlatModel(alphabet=256, init=1, inc=16, cap=8192, n_ctx=4),
}


@pytest.mark.parametrize("L", [256, 4096])
@pytest.mark.parametrize("name", sorted(_TRAIN))
def test_train_counts_matches_plain(cuda, name, L):
    """K13 == its plain version: ragged reads with a long last read at two
    lane counts; every row at or under cap."""
    model = _TRAIN[name]
    rng = np.random.default_rng(L)
    counts = rng.integers(0, 150, 3 * L).astype(np.int64)
    counts[::7] = 0
    counts[-1] = 2000
    lay = make_layout(counts, L)
    syms = rng.integers(0, model.alphabet, int(counts.sum())).astype(np.uint8)
    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(engine._counts_grid(counts, L))
    cx = None
    if isinstance(model, FlatModel):
        cx = torch.from_numpy(to_grid(lay, rng.integers(
            0, 4, len(syms)).astype(np.int32)))
    want = kernels.train_counts(g, cg, model, cx)
    kernels.reset_launch_counts()
    got = kernels.train_counts(g.to(cuda), cg.to(cuda), model,
                               None if cx is None else cx.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert int(want.long().sum(dim=1).max()) <= model.cap
    assert kernels.LAUNCHES["train_counts"] == 1


def test_semi_and_frozen_adapt_pipeline_on_card_matches_cpu(cuda, tmp_path):
    """compress_se with adapt_chunk=64, with use_model=1 and frozen_adapt=1,
    and with both: the card's archive equals the CPU's (plain versions);
    K11/K12 or K5/K6 launch, no native coder runs; it decodes on the card
    byte for byte."""
    from fastqueeze_tpu_torch.ops import host_adapt, host_frozen
    from fastqueeze_tpu_torch.pipeline import driver
    rng = np.random.default_rng(33)
    recs = []
    for r in range(1500):
        n = int(rng.integers(60, 140))
        seq = bytearray(rng.choice(list(b"ACGT"), n).astype(np.uint8))
        qual = (np.clip(np.cumsum(rng.integers(-2, 3, n)) + 30, 2, 41)
                + 33).astype(np.uint8)
        recs.append(b"@read.%d\n%s\n+\n%s\n" % (r, bytes(seq), bytes(qual)))
    fq = tmp_path / "in.fq"
    fq.write_bytes(b"".join(recs))
    for kw, path in ((dict(adapt_chunk=64), ("semi_encode_walk",
                                             "semi_decode")),
                     (dict(use_model=1, frozen_adapt=1),
                      ("adapt_encode_walk", "adapt_decode")),
                     (dict(use_model=1, frozen_adapt=1, adapt_chunk=64),
                      ("semi_encode_walk", "semi_decode"))):
        cpu, card = str(tmp_path / "cpu.fqz"), str(tmp_path / "card.fqz")
        driver.compress_se(CodecParams(**kw), str(fq), cpu, device="cpu")
        kernels.reset_launch_counts()
        for calls in (host_adapt.NATIVE_CALLS, host_frozen.NATIVE_CALLS):
            for k in calls:
                calls[k] = 0
        driver.compress_se(CodecParams(**kw), str(fq), card, device=cuda)
        out = driver.decompress(card, str(tmp_path / "back"), force=True,
                                device=cuda)
        assert open(out[0], "rb").read() == fq.read_bytes(), kw
        with open(cpu, "rb") as a, open(card, "rb") as b:
            assert a.read() == b.read(), kw
        for k in path:
            assert kernels.LAUNCHES[k] >= 2, (kw, k)
        assert not any(host_adapt.NATIVE_CALLS.values())
        assert not any(host_frozen.NATIVE_CALLS.values())


# --- the seed aligner: K8 align_batch, K9 indel_batch ------------------------

def _align_fixture(k: int, n_reads: int = 400, seed: int = 41,
                   lens=(60, 120)):
    """A seeded 40 kbp reference with a repeat family (deep candidate
    lists), an Aligner over it, and reads of every kind the tiers meet:
    clean, point errors, indels, reverse strand, random (unmappable),
    shorter than k, with an N, from inside the repeats."""
    from fastqueeze_tpu_torch.align.hash import Aligner
    from fastqueeze_tpu_torch.align.index import build_from_ref
    from fastqueeze_tpu_torch.align.ref import RefSeq
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 40_000).astype(np.uint8)
    for j in range(40):
        ref[9000 + j * 70:9000 + j * 70 + 60] = ref[:60]
    p = CodecParams(seed_len=k)
    idx = build_from_ref(RefSeq(ref, np.zeros(len(ref), bool), ["r"],
                                np.array([0, len(ref)]), ""), p)
    reads = []
    for i in range(n_reads):
        kind = i % 8
        L = int(rng.integers(*lens))
        s = (9000 + int(rng.integers(0, 35)) * 70 if kind == 6
             else int(rng.integers(0, len(ref) - L - 4)))
        r = ref[s:s + L + 3].copy()
        if kind == 1:
            e = rng.random(len(r)) < 0.06
            r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
        elif kind == 2:
            g, at = int(rng.integers(1, 4)), int(rng.integers(15, L - 15))
            r = np.concatenate([r[:at], r[at + g:]])
        elif kind == 3:
            g, at = int(rng.integers(1, 4)), int(rng.integers(15, L - 15))
            r = np.concatenate([r[:at], rng.integers(0, 4, g)
                                .astype(np.uint8), r[at:]])
        elif kind == 4:
            r = rng.integers(0, 4, L).astype(np.uint8)
        elif kind == 5:
            L = int(rng.integers(1, k))
        r = r[:L]
        if rng.random() < 0.4:
            r = (3 - r)[::-1].copy()
        reads.append(r)
    lengths = np.array([len(r) for r in reads], np.int64)
    codes = np.concatenate(reads)
    dege = np.zeros(len(codes), bool)
    dege[int(lengths[:7].sum()) + 5] = True          # read 7 carries an N
    return Aligner(idx, p), codes, dege, lengths


def _grids(al, codes, dege, lengths, lp, dev):
    from fastqueeze_tpu_torch.align.hash import _gridify
    c, d = _gridify(codes, dege, lengths, lp)
    return (torch.from_numpy(c).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))


_K8_CFGS = {
    "fwd": dict(strand="fwd", probe_k=16),
    "rc": dict(strand="rc", probe_k=16),
    "both": dict(both_strands=1, probe_k=16),
    "fallback": dict(probe_k=16),
    "rescue_small_K": dict(n_cand=1024, n_seeds=6, excl_bp=7, probe_k=8),
    "rescue": dict(n_cand=1024, n_seeds=6, excl_bp=7),
}


@pytest.mark.parametrize("k", [14, 22])
@pytest.mark.parametrize("name", sorted(_K8_CFGS))
@pytest.mark.parametrize("n", [0, 1, 333])
def test_align_batch_matches_plain_and_native(cuda, k, name, n):
    from fastqueeze_tpu_torch.align.hash import AlignConfig
    from fastqueeze_tpu_torch.io import native
    al, codes, dege, lengths = _align_fixture(k)
    lengths, codes = lengths[:n], codes[:int(lengths[:n].sum())]
    dege = dege[:len(codes)]
    lp = 128
    kw = {"n_cand": 64, "both_strands": 0, **_K8_CFGS[name]}
    cfg = AlignConfig(k=k, stride=2, max_mis=7, lp=lp, **kw)
    want = kernels.align_batch(*_grids(al, codes, dege, lengths, lp, "cpu"),
                               al.dev_index("cpu"), cfg)
    got = [t.cpu() for t in kernels.align_batch(
        *_grids(al, codes, dege, lengths, lp, cuda), al.dev_index(cuda),
        cfg)]
    m = want[0]
    assert torch.equal(got[0], m)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a[m], b[m])
    # the native mirror gives every read's position, fallbacks included
    sm = {"fwd": 0, "rc": 1, "both": 2}[cfg.strand]
    nat = native.align_batch(
        al._h_keys, al._h_offsets, al._h_positions, al._h_packed, al._h_l1,
        al._l1_shift, al._search_steps, al.ref_len, codes, dege,
        np.cumsum(lengths) - lengths, lengths, lp, k, 2, cfg.n_cand, 7,
        cfg.n_seeds, cfg.excl_bp, cfg.probe_k, sm, cfg.both_strands)
    assert np.array_equal(got[1].numpy(), nat[1])
    assert np.array_equal(got[3].numpy(), nat[3])


@pytest.mark.parametrize("k", [14, 22])
@pytest.mark.parametrize("G,ops", [(3, 1), (3, 2), (1, 2)])
def test_indel_batch_matches_plain_and_native(cuda, k, G, ops):
    from fastqueeze_tpu_torch.align.hash import AlignConfig
    from fastqueeze_tpu_torch.io import native
    al, codes, dege, lengths = _align_fixture(k)
    lp = 128
    cfg = AlignConfig(k=k, stride=2, n_cand=1024, max_mis=7, both_strands=0,
                      lp=lp, n_seeds=6, excl_bp=7)
    want = kernels.indel_batch(*_grids(al, codes, dege, lengths, lp, "cpu"),
                               al.dev_index("cpu"), cfg, G, ops)
    got = [t.cpu() for t in kernels.indel_batch(
        *_grids(al, codes, dege, lengths, lp, cuda), al.dev_index(cuda), cfg,
        G, ops)]
    f = want[0]
    assert int(f.sum()) > 100 and torch.equal(got[0], f)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a[f], b[f])
    nat = native.indel_batch(
        al._h_keys, al._h_offsets, al._h_positions, al._h_packed, al._h_l1,
        al._l1_shift, al._search_steps, al.ref_len, codes, dege,
        np.cumsum(lengths) - lengths, lengths, lp, k, 2, 1024, 7, 6, 7, 1024,
        G, ops)
    for a, b in zip(got, nat):
        assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("lp", [128, 1024])
@pytest.mark.parametrize("variant", ["rescue", "indel", "both"])
def test_rescue_indel_fused_matches_plain(cuda, lp, variant):
    """K14 against its plain version: a todo list of random rows with a
    fifth of the slots off, over reads of up to 120 bp (Lp 128) or of
    700-1,023 bp (Lp 1024, a long-read chunk's grid)."""
    from fastqueeze_tpu_torch.align.hash import AlignConfig
    al, codes, dege, lengths = _align_fixture(
        14, *((300, 41, (60, 120)) if lp == 128 else (96, 44, (700, 1024))))
    cfg = AlignConfig(k=14, stride=2, n_cand=1024, max_mis=7, both_strands=0,
                      lp=lp, n_seeds=6, excl_bp=7)
    rng = np.random.default_rng(3)
    cap = 512 if lp == 128 else 128
    idx = rng.integers(0, len(lengths), cap).astype(np.int32)
    do = rng.random(cap) < 0.8
    G, ops = (0, 0) if variant == "rescue" else (3, 2)
    cfg2 = None if variant == "indel" else cfg

    def run(dev):
        return kernels.rescue_indel_fused(
            *_grids(al, codes, dege, lengths, lp, dev),
            torch.from_numpy(idx).to(dev), torch.from_numpy(do).to(dev),
            al.dev_index(dev), cfg2, cfg, G, ops)

    want = run("cpu")
    kernels.reset_launch_counts()
    got = [t.cpu() for t in run(cuda)]
    assert kernels.LAUNCHES["rescue_indel_fused"] == 1
    m2, f = want[0], want[4]
    assert torch.equal(got[0], m2) and torch.equal(got[4], f)
    assert int(m2.sum() if cfg2 else f.sum()) > 10
    for sel, lo, hi in ((m2, 1, 4), (f, 5, 12)):
        for a, b in zip(got[lo:hi], want[lo:hi]):
            assert torch.equal(a[sel], b[sel])


def test_aligned_pipeline_on_card_matches_host_route(cuda, tmp_path,
                                                     monkeypatch):
    """compress_se_aligned on the card (K8, and K9 with -q) writes the
    same archive as with the native host aligner, and it decodes."""
    from fastqueeze_tpu_torch.io import native
    from fastqueeze_tpu_torch.pipeline import aligned, driver
    rng = np.random.default_rng(12)
    ref = rng.integers(0, 4, 60_000).astype(np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    fa = tmp_path / "ref.fa"
    fa.write_bytes(b">c\n" + bases[ref].tobytes() + b"\n")
    recs = []
    for r in range(3000):
        L = int(rng.integers(70, 130))
        s = int(rng.integers(0, len(ref) - L - 3))
        c = ref[s:s + L].copy()
        if r % 5 == 0:
            at = int(rng.integers(20, L - 20))
            c = np.concatenate([c[:at], ref[s + L:s + L + 2], c[at + 2:]])
        e = rng.random(L) < 0.02
        c[e] = (c[e] + 1) % 4
        if r % 3 == 0:
            c = (3 - c)[::-1]
        q = (np.clip(np.cumsum(rng.integers(-1, 2, L)) + 30, 2, 40)
             + 33).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (r, bases[c].tobytes(),
                                            q.tobytes()))
    fq = tmp_path / "in.fq"
    fq.write_bytes(b"".join(recs))
    for kw in (dict(), dict(seed_len=22, max_indel=3)):
        arcs = {}
        for mode in ("", "host"):
            monkeypatch.setenv("FASTQUEEZE_ALIGN_EXEC", mode)
            arcs[mode] = str(tmp_path / f"a{mode}.fqz")
            kernels.reset_launch_counts()
            native.ALIGN_CALLS["align_batch"] = 0
            aligned.compress_se_aligned(CodecParams(**kw), str(fa), str(fq),
                                        arcs[mode], device=cuda)
            if not mode:
                assert native.ALIGN_CALLS["align_batch"] == 0
                assert kernels.LAUNCHES["align_batch"] >= 2
                assert (kernels.LAUNCHES["indel_batch"] >= 1) == bool(kw)
        with open(arcs[""], "rb") as a, open(arcs["host"], "rb") as b:
            assert a.read() == b.read(), kw
        out = driver.decompress(arcs["host"], str(tmp_path / "back"),
                                force=True, device=cuda, ref=str(fa))
        assert open(out[0], "rb").read() == fq.read_bytes(), kw


# --- the warp body of K8, K9, K14: the rules it splits over 32 lanes -------

_UNIT, _REPEATS, _VAR_AT = 100, 80, 40


def _warp_edge_fixture(k: int, lp: int = 128):
    """A seeded 40 kbp reference with 80 copies of a 100 bp unit, each with
    a non-A base at unit position 40 but copy 45 (an A there), an Aligner
    over it, and reads that hit each rule the warp body splits (as
    tests/test_torch_align_warp.py builds them): the unit with an N at
    base 40 (every valid seed lists all 80 copies: ties in the verify
    order past 32 entries, the K cut and best == 0 mid-round), random
    reads (every candidate pruned), reads wrapping the reference's end
    (no valid candidate), clean, substituted and indel reads on both
    strands; at lp 1024, 700-1,000 bp reads (more samples than lanes)."""
    from fastqueeze_tpu_torch.align.hash import Aligner
    from fastqueeze_tpu_torch.align.index import build_from_ref
    from fastqueeze_tpu_torch.align.ref import RefSeq
    rng = np.random.default_rng(1102)
    ref = rng.integers(0, 4, 40_000).astype(np.uint8)
    unit = rng.integers(0, 4, _UNIT).astype(np.uint8)
    for j in range(_REPEATS):
        u = unit.copy()
        u[_VAR_AT] = 0 if j == 45 else 1 + j % 3
        at = 12_000 + j * (_UNIT + 37)
        ref[at:at + _UNIT] = u
    p = CodecParams(seed_len=k)
    idx = build_from_ref(RefSeq(ref, np.zeros(len(ref), bool), ["r"],
                                np.array([0, len(ref)]), ""), p)
    reads, dege = [], []
    n = 256 if lp == 128 else 48
    for i in range(n):
        kind = i % 6
        L = int(rng.integers(70, 110) if lp == 128
                else rng.integers(700, 1000))
        s = int(rng.integers(100, len(ref) - L - 200))
        r = ref[s:s + L + 6].copy()
        if kind == 1:
            at = rng.integers(0, L, 5 if lp > 128 else 9)
            r[at] = (r[at] + rng.integers(1, 4, len(at))) % 4
        elif kind == 2:
            g, at = int(rng.integers(1, 4)), int(rng.integers(20, L - 20))
            r = np.concatenate([r[:at], r[at + g:]])
        elif kind == 3:
            r = rng.integers(0, 4, L).astype(np.uint8)
        elif kind == 4 and lp == 128:
            r = np.concatenate([ref[-50:], ref[:60]])
            L = len(r)
        elif kind == 5 and lp == 128:
            r, L = unit.copy(), _UNIT
        r = r[:L]
        d = np.zeros(L, bool)
        d[_VAR_AT] = kind == 5 and lp == 128
        if kind in (0, 1, 2) and rng.random() < 0.4:
            r = (3 - r)[::-1].copy()
        reads.append(r)
        dege.append(d)
    lengths = np.array([len(r) for r in reads], np.int64)
    return (Aligner(idx, p), np.concatenate(reads), np.concatenate(dege),
            lengths)


_WARP_CFGS = {
    "tier1_fwd": dict(strand="fwd", probe_k=16),
    "no_prefilter": dict(strand="fwd", probe_k=32),
    "tier1_fallback": dict(probe_k=16),
    "both_strands": dict(both_strands=1, probe_k=16),
    "rescue": dict(n_cand=1024, n_seeds=6, excl_bp=7),
    "rescue_K40": dict(n_cand=1024, n_seeds=6, excl_bp=7, probe_k=40),
    "wide_masks": dict(n_cand=256, n_seeds=4, excl_bp=20, probe_k=64),
}


def _native_align(al, codes, dege, lengths, lp, cfg):
    from fastqueeze_tpu_torch.io import native
    sm = {"fwd": 0, "rc": 1, "both": 2}[cfg.strand]
    return native.align_batch(
        al._h_keys, al._h_offsets, al._h_positions, al._h_packed, al._h_l1,
        al._l1_shift, al._search_steps, al.ref_len, codes, dege,
        np.cumsum(lengths) - lengths, lengths, lp, al.k, cfg.stride,
        cfg.n_cand, cfg.max_mis, cfg.n_seeds, cfg.excl_bp, cfg.probe_k, sm,
        cfg.both_strands)


@pytest.mark.parametrize("lp", [128, 1024])
@pytest.mark.parametrize("k", [14, 22])
@pytest.mark.parametrize("name", sorted(_WARP_CFGS))
def test_align_batch_warp_edges(cuda, lp, k, name):
    """K8's warp body on the reads built for its rules: every output of
    every read equal to the plain version's, and the native mirror's."""
    from fastqueeze_tpu_torch.align.hash import AlignConfig
    al, codes, dege, lengths = _warp_edge_fixture(k, lp)
    cfg = AlignConfig(k=k, stride=2, max_mis=7, lp=lp,
                      **{"n_cand": 64, "both_strands": 0,
                         **_WARP_CFGS[name]})
    want = kernels.align_batch(*_grids(al, codes, dege, lengths, lp, "cpu"),
                               al.dev_index("cpu"), cfg)
    got = [t.cpu() for t in kernels.align_batch(
        *_grids(al, codes, dege, lengths, lp, cuda), al.dev_index(cuda),
        cfg)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    nat = _native_align(al, codes, dege, lengths, lp, cfg)
    assert np.array_equal(got[1].numpy(), nat[1])
    assert np.array_equal(got[3].numpy(), nat[3])


@pytest.mark.parametrize("lp", [128, 1024])
@pytest.mark.parametrize("k", [14, 22])
def test_indel_and_fused_warp_edges(cuda, lp, k):
    """K9 (G = 3, two ops) and K14 (both halves, a shuffled todo list with
    a fifth of the slots off) on the same reads: K9 equal to the native
    mirror on every output and to the plain version on found and the
    found reads' outputs; K14 to its plain version on m2, f and the
    outputs of the slots they select."""
    from fastqueeze_tpu_torch.align.hash import AlignConfig
    from fastqueeze_tpu_torch.io import native
    al, codes, dege, lengths = _warp_edge_fixture(k, lp)
    cfg = AlignConfig(k=k, stride=2, n_cand=1024, max_mis=7, both_strands=0,
                      lp=lp, n_seeds=6, excl_bp=7)
    want = kernels.indel_batch(*_grids(al, codes, dege, lengths, lp, "cpu"),
                               al.dev_index("cpu"), cfg, 3, 2)
    got = [t.cpu() for t in kernels.indel_batch(
        *_grids(al, codes, dege, lengths, lp, cuda), al.dev_index(cuda), cfg,
        3, 2)]
    f = want[0]
    assert torch.equal(got[0], f) and int(f.sum()) > 5
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a[f], b[f])
    nat = native.indel_batch(
        al._h_keys, al._h_offsets, al._h_positions, al._h_packed, al._h_l1,
        al._l1_shift, al._search_steps, al.ref_len, codes, dege,
        np.cumsum(lengths) - lengths, lengths, lp, k, 2, 1024, 7, 6, 7, 1024,
        3, 2)
    for a, b in zip(got, nat):
        assert np.array_equal(a.numpy(), b)
    rng = np.random.default_rng(4)
    cap = 256 if lp == 128 else 64
    idx = rng.integers(0, len(lengths), cap).astype(np.int32)
    do = rng.random(cap) < 0.8

    def run(dev):
        return kernels.rescue_indel_fused(
            *_grids(al, codes, dege, lengths, lp, dev),
            torch.from_numpy(idx).to(dev), torch.from_numpy(do).to(dev),
            al.dev_index(dev), cfg, cfg, 3, 2)

    want, got = run("cpu"), [t.cpu() for t in run(cuda)]
    m2, f = want[0], want[4]
    assert torch.equal(got[0], m2) and torch.equal(got[4], f)
    for sel, lo, hi in ((m2, 1, 4), (f, 5, 12)):
        for a, b in zip(got[lo:hi], want[lo:hi]):
            assert torch.equal(a[sel], b[sel])


@pytest.mark.parametrize("tier", ["rescue", "indel", "fused"])
def test_aligner_kernels_at_the_default_batch(cuda, tier):
    """K8's rescue, K9 and K14 over one batch of the sizes Aligner uses
    (RESCUE_BATCH reads; K14 over BATCH slots), held to their plain
    versions."""
    from fastqueeze_tpu_torch.align.hash import AlignConfig, Aligner
    n = Aligner.RESCUE_BATCH if tier != "fused" else Aligner.BATCH
    al, codes, dege, lengths = _align_fixture(14, n_reads=n, seed=47)
    cfg = AlignConfig(k=14, stride=2, n_cand=1024, max_mis=7, both_strands=0,
                      lp=128, n_seeds=6, excl_bp=7)
    grids = {d: _grids(al, codes, dege, lengths, 128, d)
             for d in ("cpu", cuda)}
    if tier == "rescue":
        want = kernels.align_batch(*grids["cpu"], al.dev_index("cpu"), cfg)
        got = [t.cpu() for t in kernels.align_batch(
            *grids[cuda], al.dev_index(cuda), cfg)]
        sel, lo, hi = [(want[0], 1, 4)], 0, 0
    elif tier == "indel":
        want = kernels.indel_batch(*grids["cpu"], al.dev_index("cpu"), cfg,
                                   3, 2)
        got = [t.cpu() for t in kernels.indel_batch(
            *grids[cuda], al.dev_index(cuda), cfg, 3, 2)]
        sel = [(want[0], 1, 8)]
    else:
        idx = np.random.default_rng(6).permutation(n).astype(np.int32)
        do = np.arange(n) % 5 != 0

        def run(dev):
            return kernels.rescue_indel_fused(
                *grids[dev], torch.from_numpy(idx).to(dev),
                torch.from_numpy(do).to(dev), al.dev_index(dev), cfg, cfg,
                3, 2)
        want, got = run("cpu"), [t.cpu() for t in run(cuda)]
        assert torch.equal(got[4], want[4])
        sel = [(want[0], 1, 4), (want[4], 5, 12)]
    assert torch.equal(got[0], want[0]) and int(sel[0][0].sum()) > 100
    for m, lo, hi in sel:
        for a, b in zip(got[lo:hi], want[lo:hi]):
            assert torch.equal(a[m], b[m])


# --- K10 window_batch: the PE mate-rescue window -----------------------------

def _window_fixture(B: int = 1024, C: int = 1128, seed: int = 43):
    """A seeded 4 Mbp reference, its Aligner, and B reads with window
    centers: seedless mates (substitutions every 14 bases) on both
    strands, reads with an N, windows at both ends of the reference,
    random reads and reads outside their window."""
    from fastqueeze_tpu_torch.align.hash import Aligner
    from fastqueeze_tpu_torch.align.index import build_from_ref
    from fastqueeze_tpu_torch.align.ref import RefSeq
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 4_000_000).astype(np.uint8)
    p = CodecParams()
    al = Aligner(build_from_ref(RefSeq(ref, np.zeros(len(ref), bool), ["r"],
                                       np.array([0, len(ref)]), ""), p), p)
    G = len(ref)
    reads, centers = [], []
    for i in range(B):
        kind = i % 8
        L = int(rng.integers(60, 129))
        s = {3: int(rng.integers(0, 30)),
             4: G - L - int(rng.integers(0, 30))}.get(
                 kind, int(rng.integers(C, G - C - L)))
        r = ref[s:s + L].copy()
        if kind in (0, 1, 3, 4):
            at = np.arange(7, L, 14)[:7]
            r[at] = (r[at] + rng.integers(1, 4, len(at))) % 4
        elif kind == 5:
            r = rng.integers(0, 4, L).astype(np.uint8)
        if kind in (1, 4) or rng.random() < 0.3:
            r = (3 - r)[::-1].copy()
        d = C if kind == 6 else int(rng.integers(-(C // 2) + 2, C // 2 - 2))
        reads.append(r)
        centers.append(s + d)
    lengths = np.array([len(r) for r in reads], np.int64)
    codes = np.concatenate(reads)
    dege = np.zeros(len(codes), bool)
    dege[(np.cumsum(lengths) - lengths)[2::16] + 5] = True
    return al, codes, dege, lengths, np.array(centers, np.int32)


def test_window_batch_matches_plain_and_native(cuda):
    from fastqueeze_tpu_torch.io import native
    C, lp = 1128, 128
    al, codes, dege, lengths, centers = _window_fixture(C=C)
    c, d, ln = _grids(al, codes, dege, lengths, lp, cuda)
    ctr = torch.from_numpy(centers).to(cuda)
    packed = al.dev_index(cuda).packed
    before = kernels.LAUNCHES["window_batch"]
    got = [t.cpu() for t in kernels.window_batch(packed, al.ref_len, c, d,
                                                 ln, ctr, C, 7)]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["window_batch"] == before + 1
    want = kernels.window_batch_plain(packed, al.ref_len, c, d, ln, ctr, C,
                                      7)
    nat = native.window_batch(al._h_packed, al.ref_len, codes, dege,
                              np.cumsum(lengths) - lengths, lengths, centers,
                              lp, C, 7)
    m = got[0].numpy()
    assert 400 < m.sum() < 1000 and got[2].numpy()[m].any()
    assert np.array_equal(m, want[0].cpu().numpy())
    assert np.array_equal(m, nat[0])
    for a, b, n in zip(got[1:], want[1:], nat[1:]):
        assert np.array_equal(a.numpy()[m], b.cpu().numpy()[m])
        assert np.array_equal(a.numpy()[m], n[m])


def test_window_batch_refusals(cuda):
    B, lp = 8, 64
    packed = torch.zeros(100, dtype=torch.int32, device=cuda)
    c = torch.zeros((B, lp), dtype=torch.uint8, device=cuda)
    d = torch.zeros((B, lp), dtype=torch.bool, device=cuda)
    ln = torch.full((B,), 40, dtype=torch.int32, device=cuda)
    ctr = torch.full((B,), 500, dtype=torch.int32, device=cuda)
    bad = [
        (packed, c.long(), d, ln, ctr, 188),           # codes dtype
        (packed, c, d, ln.long(), ctr, 188),           # lengths dtype
        (packed, c, d[:, :48].contiguous(), ln, ctr, 188),  # dege shape
        (packed, c, d, ln[:4], ctr, 188),              # lengths count
        (packed, c[:, :40].contiguous(), d[:, :40].contiguous(), ln, ctr,
         188),                                         # lp % 16
        (packed, c, d, ln, ctr, 0),                    # C <= 0
        (packed, c, d, ln, ctr.cpu(), 188),            # two devices
        (packed[:0], c, d, ln, ctr, 188),              # empty reference
    ]
    before = kernels.LAUNCHES["window_batch"]
    for pk, cc, dd, ll, ce, C in bad:
        with pytest.raises(ValueError):
            kernels.window_batch(pk, 1600, cc, dd, ll, ce, C, 7)
    assert kernels.LAUNCHES["window_batch"] == before


_WINDOW_REF = {}


def _window_ref():
    """A seeded 2 Mbp reference and its Aligner, built once: a tandem
    repeat (200 bases twice from 500,000: exact ties 200 apart), a
    period-8 run at 600,000 (exact ties inside one round of 32
    candidates) and a reverse-complement palindrome at 700,000."""
    if not _WINDOW_REF:
        from fastqueeze_tpu_torch.align.hash import Aligner
        from fastqueeze_tpu_torch.align.index import build_from_ref
        from fastqueeze_tpu_torch.align.ref import RefSeq
        rng = np.random.default_rng(47)
        ref = rng.integers(0, 4, 2_000_000).astype(np.uint8)
        ref[500_200:500_400] = ref[500_000:500_200]
        ref[600_000:600_400] = np.tile(ref[600_000:600_008], 50)
        x = ref[700_000:700_400].copy()
        ref[700_400:700_800] = (3 - x)[::-1]
        p = CodecParams()
        _WINDOW_REF.update(ref=ref, al=Aligner(build_from_ref(RefSeq(
            ref, np.zeros(len(ref), bool), ["r"], np.array([0, len(ref)]),
            ""), p), p))
    return _WINDOW_REF["ref"], _WINDOW_REF["al"]


def _window_case(lp: int, C: int, B: int = 1024, seed: int = 53):
    """B reads of at most lp bases with window centers: mapped forward and
    reverse (~3% substitutions), seedless-like (a substitution every 14
    bases), random, outside the window, windows at both ends of the
    reference, exact ties (the repeat, the period-8 run, the palindrome
    with one substitution), lengths lp and 1, and reads with an N."""
    ref, al = _window_ref()
    G = len(ref)
    rng = np.random.default_rng(seed + lp + C)
    reads, centers = [], []
    for i in range(B):
        kind = i % 8
        L = lp if i % 11 == 3 else (1 if i % 97 == 5 else
                                     int(rng.integers(lp // 2, lp + 1)))
        s = int(rng.integers(C + 5, G - C - L - 5))
        d = int(rng.integers(0, C))          # the true start in the window
        if kind == 3:
            s = int(rng.integers(0, 12))
        elif kind == 4:
            s = G - L - int(rng.integers(0, 12))
        elif kind == 6 and i % 16 == 6:
            L = min(L, 200)
            s = 500_000 + int(rng.integers(0, 201 - L))
            d = min(d, max(C - 201, 0))
        elif kind == 6:
            L = min(L, 300)
            s = 600_000 + int(rng.integers(0, 401 - L))
            d = min(d, max(C - 33, 0))
        elif kind == 7:
            s = 700_400 - L // 2
        r = ref[s:s + L].copy()
        if kind == 0:
            e = rng.random(L) < 0.03
            r[e] = (r[e] + 1) % 4
        elif kind == 1:
            at = np.arange(7, L, 14)
            r[at] = (r[at] + rng.integers(1, 4, len(at))) % 4
        elif kind == 5:
            r = rng.integers(0, 4, L).astype(np.uint8)
        elif kind == 7:
            r[L // 3] = (r[L // 3] + 1) % 4
        if kind in (1, 4) or (kind == 0 and i % 16 == 8):
            r = (3 - r)[::-1].copy()
        if kind == 2:
            d = C + 3
        reads.append(r)
        centers.append(s - d + C // 2)
    lengths = np.array([len(r) for r in reads], np.int64)
    codes = np.concatenate(reads)
    dege = np.zeros(len(codes), bool)
    dege[(np.cumsum(lengths) - lengths)[9::10]] = True
    return al, codes, dege, lengths, np.array(centers, np.int32)


@pytest.mark.parametrize("C", [188, 1128, 4096])
@pytest.mark.parametrize("lp", [32, 128, 256, 384])
def test_window_batch_residue_scan(cuda, lp, C):
    """K10 (frame words in registers up to Lp 256, in shared memory at
    384) == its plain version and the native mirror on mapped and on the
    mapped reads' pos, strand and mask, with degenerate reads, windows at
    both ends and exact ties; one launch."""
    from fastqueeze_tpu_torch.io import native
    al, codes, dege, lengths, centers = _window_case(lp, C)
    c, d, ln = _grids(al, codes, dege, lengths, lp, cuda)
    ctr = torch.from_numpy(centers).to(cuda)
    packed = al.dev_index(cuda).packed
    kernels.reset_launch_counts()
    got = [t.cpu() for t in kernels.window_batch(packed, al.ref_len, c, d,
                                                 ln, ctr, C, 7)]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["window_batch"] == 1
    want = kernels.window_batch_plain(packed, al.ref_len, c, d, ln, ctr, C,
                                      7)
    nat = native.window_batch(al._h_packed, al.ref_len, codes, dege,
                              np.cumsum(lengths) - lengths, lengths, centers,
                              lp, C, 7)
    m = got[0].numpy()
    assert m.sum() > len(m) // 3 and not m[9::10].any()
    assert got[2].numpy()[m].any() and not got[2].numpy()[m].all()
    assert np.array_equal(m, want[0].cpu().numpy())
    assert np.array_equal(m, nat[0])
    for a, b, n in zip(got[1:], want[1:], nat[1:]):
        assert np.array_equal(a.numpy()[m], b.cpu().numpy()[m])
        assert np.array_equal(a.numpy()[m], n[m])
    # every row written: unmapped rows' masks are all False
    assert not got[3].numpy()[~m].any()


def test_window_batch_on_unaligned_rows(cuda):
    """Codes and flags that start one byte into their buffers take K10's
    byte loads: == the aligned call."""
    lp, C = 128, 188
    al, codes, dege, lengths, centers = _window_case(lp, C, B=256)
    c, d, ln = _grids(al, codes, dege, lengths, lp, cuda)
    cb = torch.zeros(c.numel() + 1, dtype=torch.uint8, device=cuda)
    db = torch.zeros(d.numel() + 1, dtype=torch.bool, device=cuda)
    cb[1:] = c.reshape(-1)
    db[1:] = d.reshape(-1)
    cu, du = cb[1:].view(c.shape), db[1:].view(d.shape)
    assert cu.data_ptr() % 4 and cu.is_contiguous()
    ctr = torch.from_numpy(centers).to(cuda)
    packed = al.dev_index(cuda).packed
    a = kernels.window_batch(packed, al.ref_len, c, d, ln, ctr, C, 7)
    b = kernels.window_batch(packed, al.ref_len, cu, du, ln, ctr, C, 7)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pe_insert_pipeline_on_card_matches_host_route(cuda, tmp_path,
                                                       monkeypatch):
    """compress_pe against a reference with max_insr = 500 on the card
    (K8 and K10) writes the archive of the native host aligner, and it
    decodes on the card."""
    from fastqueeze_tpu_torch.io import native
    from fastqueeze_tpu_torch.pipeline import driver, pe
    from fastqueeze_tpu_torch.utils.metrics import DebugInfo
    rng = np.random.default_rng(14)
    ref = rng.integers(0, 4, 60_000).astype(np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    fa = tmp_path / "ref.fa"
    fa.write_bytes(b">c\n" + bases[ref].tobytes() + b"\n")
    recs = [[], []]
    n_seedless = 0
    for r in range(1500):
        s, ins = int(rng.integers(0, len(ref) - 600)), int(
            rng.integers(200, 501))
        m1, m2 = ref[s:s + 100].copy(), ref[s + ins - 100:s + ins].copy()
        e = rng.random(100) < 0.01
        m1[e] = (m1[e] + 1) % 4
        if r % 4 == 0 and m2[7] < 3:
            # seedless mate 2 (substitutions every 14 bases); the first
            # one raises the base, so the aligner's no-hit fallback (the
            # index entries from the first seed's insertion point on)
            # cannot list the true locus: only the window maps it
            m2[21::14] = (m2[21::14] + 1) % 4
            m2[7] = rng.integers(m2[7] + 1, 4)
            n_seedless += 1
        for k, cc in enumerate((m1, (3 - m2)[::-1])):
            q = (np.clip(np.cumsum(rng.integers(-1, 2, 100)) + 30, 2, 40)
                 + 33).astype(np.uint8)
            recs[k].append(b"@p%d\n%s\n+\n%s\n" % (r, bases[cc].tobytes(),
                                                  q.tobytes()))
    ins = [tmp_path / "in_1.fq", tmp_path / "in_2.fq"]
    for f, rr in zip(ins, recs):
        f.write_bytes(b"".join(rr))
    arcs = {}
    for mode in ("", "host"):
        monkeypatch.setenv("FASTQUEEZE_ALIGN_EXEC", mode)
        arcs[mode] = str(tmp_path / f"a{mode}.fqz")
        kernels.reset_launch_counts()
        for k in native.ALIGN_CALLS:
            native.ALIGN_CALLS[k] = 0
        dbg = DebugInfo()
        pe.compress_pe(CodecParams(max_insr=500), str(ins[0]), str(ins[1]),
                       arcs[mode], ref=str(fa), dbg=dbg, device=cuda)
        assert dbg.vals["pe_rescued"] >= 0.9 * n_seedless > 200
        if not mode:
            assert sum(native.ALIGN_CALLS.values()) == 0
            assert kernels.LAUNCHES["window_batch"] >= 1
            assert kernels.LAUNCHES["align_batch"] >= 2
    with open(arcs[""], "rb") as a, open(arcs["host"], "rb") as b:
        assert a.read() == b.read()
    outs = driver.decompress(arcs["host"], str(tmp_path / "back"),
                             force=True, device=cuda, ref=str(fa))
    for out, f in zip(outs, ins):
        assert open(out, "rb").read() == f.read_bytes()


# --- K15-K17: the transfer packs; K1 on narrow tables ----------------------

def _skewed_grid(rng, A, T, L, p_top):
    g = rng.integers(0, A, (T, L))
    hot = rng.random((T, L)) < p_top
    g[hot] = rng.permutation(A)[rng.integers(0, 3, int(hot.sum()))]
    return g.astype(np.uint8)


@pytest.mark.parametrize("T,L", [(37, 1028), (300, 4096), (0, 64)])
@pytest.mark.parametrize("mode", [2, 4, 6, 15, 23])
def test_unpack_grid_matches_plain(cuda, mode, T, L):
    """K15 on ragged tiles (T * L not a multiple of 4096), a full-width
    grid and an empty one; the sentinel modes on the host's own packs."""
    rng = np.random.default_rng(mode)
    A = {2: 4, 4: 16, 6: 48, 15: 48, 23: 16}[mode]
    grid = _skewed_grid(rng, A, T, L, 0.99 if mode in (15, 23) else 0.3)
    if mode in (15, 23):
        sent = 15 if mode == 15 else 3
        cnt = np.bincount(grid.reshape(-1), minlength=64)
        top = np.argsort(-cnt, kind="stable")[:sent]
        top = top[cnt[top] > 0].astype(np.uint8)
        packed, side = engine._pack_sent_host(
            grid, top, sent,
            engine._pack4_host if mode == 15 else engine._pack2_host)
        side = torch.from_numpy(side)
    else:
        packed, side = engine._pack_host(grid, mode), None
    packed = torch.from_numpy(packed)
    want = kernels.unpack_grid(packed, mode, side)
    assert np.array_equal(want.numpy(), grid)
    got = kernels.unpack_grid(packed.to(cuda), mode,
                              None if side is None else side.to(cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode", [15, 23])
def test_unpack_grid_clamps_a_short_sidecar(cuda, mode):
    rng = np.random.default_rng(9)
    packed = torch.from_numpy(rng.integers(0, 256, (64, 96)).astype(np.uint8))
    side = torch.from_numpy(rng.integers(0, 64, 21).astype(np.uint8))
    want = kernels.unpack_grid(packed, mode, side)
    got = kernels.unpack_grid(packed.to(cuda), mode, side.to(cuda))
    assert torch.equal(got.cpu(), want)


def _packed_case(rng, mode, T, L):
    """A (T, L) grid and its pack (with the host's sidecar in modes 15 and
    23: ~5% of the slots outside the top symbols)."""
    if mode in (15, 23):
        grid = _skewed_grid(rng, 48, T, L, 0.95)
        sent = 15 if mode == 15 else 3
        cnt = np.bincount(grid.reshape(-1), minlength=64)
        top = np.argsort(-cnt, kind="stable")[:sent]
        top = top[cnt[top] > 0].astype(np.uint8)
        packed, side = engine._pack_sent_host(
            grid, top, sent,
            engine._pack4_host if mode == 15 else engine._pack2_host)
        return grid, packed, torch.from_numpy(side)
    grid = rng.integers(0, 1 << mode, (T, L)).astype(np.uint8)
    return grid, engine._pack_host(grid, mode), None


# grid sizes (T, L = 4) around K15's 16-slot group, its 8,192-slot
# sentinel tile and its 16,384-slot dense block (4 groups x 256 threads)
_K15_N = [4, 12, 16, 20, 4092, 4096, 4100, 8188, 8192, 8196, 3 * 4096 + 12,
          16384 - 4, 16384, 16384 + 4, 37 * 4096 + 4, 330 * 8192 + 36]


@pytest.mark.parametrize("n", _K15_N)
@pytest.mark.parametrize("mode", [2, 4, 6, 15, 23])
def test_unpack_grid_around_groups_and_tiles(cuda, mode, n):
    """K15 == its plain version at sizes around the group, the tile and
    the dense block; one launch a call, counted under its mode."""
    rng = np.random.default_rng(n * 5 + mode)
    grid, packed, side = _packed_case(rng, mode, n // 4, 4)
    want = kernels.unpack_grid(torch.from_numpy(packed), mode, side)
    assert np.array_equal(want.numpy(), grid)
    kernels.reset_launch_counts()
    got = kernels.unpack_grid(torch.from_numpy(packed).to(cuda), mode,
                              None if side is None else side.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert kernels.LAUNCHES["unpack_grid"] == 1
    assert kernels.UNPACK_MODES == {m: int(m == mode)
                                    for m in kernels.UNPACK_MODES}


@pytest.mark.parametrize("mode", [2, 4, 6, 15, 23])
def test_unpack_grid_on_an_unaligned_view(cuda, mode):
    """A packed grid that starts one row into its buffer (a row of 257,
    514 or 771 bytes: no 4- or 8-byte alignment) takes the byte path of
    the same kernel, == the plain version."""
    rng = np.random.default_rng(mode + 40)
    T, L = 75, 1028
    grid, packed, side = _packed_case(rng, mode, T, L)
    buf = np.concatenate([rng.integers(0, 256, (1, packed.shape[1]))
                          .astype(np.uint8), packed])
    view = torch.from_numpy(buf).to(cuda)[1:]
    assert view.is_contiguous() and view.data_ptr() % 4
    sd = None if side is None else side.to(cuda)
    got = kernels.unpack_grid(view, mode, sd)
    assert np.array_equal(got.cpu().numpy(), grid)
    assert torch.equal(got.cpu(), kernels.unpack_grid(
        torch.from_numpy(packed), mode, side))


@pytest.mark.parametrize("mode", [15, 23])
def test_unpack_grid_refuses_2_31_slots(cuda, mode):
    """The sentinel modes' look-back prefixes are 32-bit: T * L >= 2^31
    is refused before any launch."""
    L = 1 << 15
    T = (1 << 31) // L
    packed = torch.empty((T, kernels.packed_width(mode, L)),
                         dtype=torch.uint8, device=cuda)
    side = torch.zeros(17, dtype=torch.uint8, device=cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="2\\^31"):
        kernels.unpack_grid(packed, mode, side)
    assert kernels.LAUNCHES["unpack_grid"] == 0
    del packed
    torch.cuda.empty_cache()


_K1_NP = {torch.uint8: np.uint8, torch.int16: np.uint16,
          torch.int32: np.int32}
_K1_HI = {torch.uint8: 255, torch.int16: 65535, torch.int32: 2**31 - 1}


def _extreme_table(rng, dtype, A):
    """Random rows, rows of the largest count, an all-zero row, and rows
    whose totals are 1, powers of two, one below and 2^22 where the
    count type reaches them."""
    hi = _K1_HI[dtype]
    rows = [rng.integers(0, hi + 1, (3000, A), dtype=np.int64),
            np.full((2, A), hi, np.int64), np.zeros((1, A), np.int64)]
    for tot in ([1, 2**22] + [2**k for k in (1, 8, 16, 30)]
                + [2**k - 1 for k in (2, 8, 16, 30)]):
        if tot <= A * hi:
            base, extra = divmod(tot, A)
            r = np.full(A, base, np.int64)
            r[:extra] += 1
            rows.append(rng.permutation(r)[None])
    c = np.concatenate(rows).astype(_K1_NP[dtype])
    return torch.from_numpy(c.view(np.int16) if dtype == torch.int16 else c)


@pytest.mark.parametrize("A", [2, 4, 41, 48, 64, 256])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
def test_quant_pack_extreme_tables(cuda, dtype, A):
    """K1 (a thread a row through shared memory up to A = 8, a warp a row
    above) == its plain version on rows of extreme totals, also on a
    view that starts one row into its buffer (unaligned for A <= 8);
    one launch a call."""
    table = _extreme_table(np.random.default_rng(A + 3), dtype, A)
    want = kernels.quant_pack(table)
    kernels.reset_launch_counts()
    got = kernels.quant_pack(table.to(cuda))
    view = kernels.quant_pack(table.to(cuda)[1:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quant_pack"] == 2
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    vc, vp = kernels.quant_pack_plain(table[1:])
    assert torch.equal(view[0].cpu(), vc) and torch.equal(view[1].cpu(), vp)


@pytest.mark.parametrize("dtype,A", [(torch.uint8, 333), (torch.uint8, 1000),
                                     (torch.int16, 2000),
                                     (torch.int16, 8200),
                                     (torch.int32, 1001),
                                     (torch.int32, 4100)])
def test_quant_pack_wide_rows(cuda, dtype, A):
    """K1 on wide rows: tiles of 16 rows (333 u8 counts) and 4 rows
    (1,001 i32), tiles whose runs are no multiple of 16 bytes, copied by
    bytes (1,000 u8: 5 rows, 2,000 u16: 2), and rows too wide for a tile
    in shared memory, read and written where they lie (8,200 u16, 4,100
    i32)."""
    rng = np.random.default_rng(A)
    c = rng.integers(0, _K1_HI[dtype] + 1, (150, A)).astype(_K1_NP[dtype])
    table = torch.from_numpy(c.view(np.int16) if dtype == torch.int16
                             else c)
    got = kernels.quant_pack(table.to(cuda))
    for a, b in zip(got, kernels.quant_pack_plain(table)):
        assert torch.equal(a.cpu(), b)


def test_quant_pack_on_the_q3_table(cuda):
    """K1 on the --qlevel 3 table's shape, 1,048,576 x 41 u16 counts up to
    65,535 == its plain version."""
    rng = np.random.default_rng(17)
    t = torch.from_numpy(rng.integers(1, 65536, (1 << 20, 41))
                         .astype(np.uint16).view(np.int16)).to(cuda)
    got = kernels.quant_pack(t)
    want = kernels.quant_pack_plain(t)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", [2, 4, 6])
def test_pack_grid_matches_plain(cuda, mode):
    grid = torch.from_numpy(np.random.default_rng(mode).integers(
        0, 1 << mode, (75, 2052)).astype(np.uint8))
    want = kernels.pack_grid(grid, mode)
    assert torch.equal(kernels.pack_grid(grid.to(cuda), mode).cpu(), want)


# grid sizes (T, L = 4) around K16's 256-thread block (1,024 slots, a
# 4-slot group a thread) and past many: n % 16 in {0, 4, 8, 12}
_K16_N = [4, 8, 12, 16, 20, 1024 - 4, 1024, 1024 + 8, 16384 + 12,
          37 * 16384 + 4, 330 * 16384 + 12]


@pytest.mark.parametrize("n", _K16_N)
@pytest.mark.parametrize("mode", [2, 4, 6])
def test_pack_grid_around_groups_and_blocks(cuda, mode, n):
    """K16 == its plain version on bytes over the full 0-255 range (the
    reference's unmasked ORs, truncated) around the block and at the
    grid's end; one launch a call."""
    g = torch.from_numpy(np.random.default_rng(n * 3 + mode).integers(
        0, 256, (n // 4, 4)).astype(np.uint8))
    want = kernels.pack_grid(g, mode)
    kernels.reset_launch_counts()
    got = kernels.pack_grid(g.to(cuda), mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pack_grid"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode", [2, 4, 6])
def test_pack_grid_on_an_unaligned_view(cuda, mode):
    """A grid that starts one row into its buffer (rows of 1,028 bytes:
    4-byte but no 16-byte alignment) == the plain version and the host
    pack; one launch."""
    rng = np.random.default_rng(mode + 70)
    T, L = 75, 1028
    buf = rng.integers(0, 1 << mode, (T + 1, L)).astype(np.uint8)
    view = torch.from_numpy(buf).to(cuda)[1:]
    assert view.is_contiguous() and view.data_ptr() % 16
    kernels.reset_launch_counts()
    got = kernels.pack_grid(view, mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pack_grid"] == 1
    assert np.array_equal(got.cpu().numpy(), engine._pack_host(buf[1:], mode))
    assert torch.equal(got.cpu(), kernels.pack_grid(
        torch.from_numpy(buf[1:].copy()), mode))


@pytest.mark.parametrize("case", ["skewed", "flat", "short_lanes"])
def test_pack15_matches_plain(cuda, case):
    """K17: the top 15 of the valid slots (ties to the lower symbol),
    invalid slots as top[0], the exceptions below the cap, the count of
    all of them; the sidecar overflows on the flat grid."""
    rng = np.random.default_rng(len(case))
    T, L = 211, 1024
    grid = _skewed_grid(rng, 48, T, L, 0.98 if case == "skewed" else 0.0)
    J = 3
    lens = rng.integers(0, T // J + 1, (J, L)).astype(np.int32)
    if case == "short_lanes":
        lens[:, ::5] = 0
    g, cg = torch.from_numpy(grid), torch.from_numpy(lens)
    want = kernels.pack15(g, cg)
    got = kernels.pack15(g.to(cuda), cg.to(cuda))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert (int(want[2].item()) > T * L // 4) == (case != "skewed")


def _pack15_case(case, rng):
    """(grid, read lengths) of a K17 case: L = 12 and 20 (L % 4 == 0, not %
    16), a grid of 2.6 tiles (16,384 slots a tile), every lane empty,
    40 symbols of exactly equal counts and a flat grid (both n_exc >
    cap), and
    the smoke's frozen shape (6,144 x 4,096: 1,536 tiles) with Markov-like
    crowding."""
    T, L = {"L12": (1001, 12), "L20": (733, 20), "tiles": (41, 1052),
            "empty_lanes": (300, 512), "ties": (300, 512),
            "over_cap": (97, 2048), "frozen_shape": (6144, 4096)}[case]
    if case == "ties":
        g = rng.permutation(np.repeat(np.arange(40), T * L // 40))
        g = g.reshape(T, L)
    elif case == "over_cap":
        g = rng.integers(0, 48, (T, L))
    else:
        g = _skewed_grid(rng, 48, T, L, 0.9)
    J = 4
    lens = rng.integers(0, T // J + 1, (J, L))
    if case == "empty_lanes":
        lens[:] = 0
    elif case == "ties":
        lens[:] = 0
        lens[0] = T
    return (torch.from_numpy(g.astype(np.uint8)),
            torch.from_numpy(lens.astype(np.int32)))


@pytest.mark.parametrize("case", ["L12", "L20", "tiles", "empty_lanes",
                                  "ties", "over_cap", "frozen_shape"])
def test_pack15_tiles_match_plain(cuda, case):
    """K17 (a histogram pass, then the write pass with its look-back over
    the tiles) == its plain version, nibbles, sidecar and count, in one
    launch a call; the same outputs on a second call."""
    g, cg = _pack15_case(case, np.random.default_rng(len(case)))
    T, L = g.shape
    want = kernels.pack15(g, cg)
    kernels.reset_launch_counts()
    gc, cgc = g.to(cuda), cg.to(cuda)
    got = kernels.pack15(gc, cgc)
    again = kernels.pack15(gc, cgc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pack15"] == 2
    for a, b, c in zip(got, want, again):
        assert torch.equal(a.cpu(), b) and torch.equal(c.cpu(), b)
    n_exc, cap = int(want[2].item()), T * L // 4
    assert (n_exc > cap) == (case in ("over_cap", "ties"))
    if case == "empty_lanes":
        assert n_exc == 0 and list(want[1][:15]) == list(range(15))
    if case == "ties":
        assert list(want[1][:15]) == list(range(15))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
def test_quant_pack_reads_narrow_tables(cuda, dtype):
    rng = np.random.default_rng(5)
    hi = {torch.uint8: 256, torch.int16: 65536, torch.int32: 1 << 22}[dtype]
    wide = rng.integers(1, hi, (4097, 41)).astype(np.int64)
    narrow = torch.from_numpy(wide.astype(
        {torch.uint8: np.uint8, torch.int16: np.uint16,
         torch.int32: np.int32}[dtype]).view(
        {torch.uint8: np.uint8, torch.int16: np.int16,
         torch.int32: np.int32}[dtype]))
    want = kernels.quant_pack(torch.from_numpy(wide.astype(np.int32)))
    got = kernels.quant_pack(narrow.to(cuda))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_pack_wrappers_raise_on_bad_input(cuda):
    g = torch.zeros((8, 6), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        kernels.pack_grid(g, 2)                   # L % 4
    with pytest.raises(ValueError):
        kernels.pack_grid(g[:, :4].contiguous(), 15)   # no dense mode 15
    p = torch.zeros((8, 4), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        kernels.unpack_grid(p, 15, torch.zeros(16, dtype=torch.uint8,
                                               device=cuda))  # no slot
    with pytest.raises(ValueError):
        kernels.unpack_grid(p, 2, torch.zeros(20, dtype=torch.uint8,
                                              device=cuda))   # no sidecar
    with pytest.raises(ValueError):
        kernels.pack15(g, torch.zeros((1, 6), dtype=torch.int32,
                                      device=cuda))           # L % 4


@pytest.mark.parametrize("name", ["seq", "qual6", "qual4"])
def test_engine_packs_on_card_match_cpu(cuda, name):
    """encode_stream / decode_stream / train_counts on the card (K15 on
    upload, K16 / K17 before the copy back) == the CPU's plain run."""
    model = {"seq": SeqModel(alphabet=4, order=6),
             "qual6": QualModel(alphabet=40, qlevel=2),
             "qual4": QualModel(alphabet=16, qlevel=2)}[name]
    rng = np.random.default_rng(3)
    counts = rng.integers(20, 160, 4000).astype(np.int64)
    syms = rng.integers(0, model.alphabet, int(counts.sum())).astype(np.uint8)
    syms[rng.random(syms.size) < 0.9] = 1            # skewed: mode 15/23
    table = rng.integers(1, 250, (model.n_ctx, model.alphabet)).astype(
        np.uint8)
    p = CodecParams()
    kernels.reset_launch_counts()
    pay = engine.encode_stream(model, p, syms, counts, counts0=table,
                               device=cuda)
    assert pay == engine.encode_stream(model, p, syms, counts,
                                       counts0=table, device="cpu")
    back = engine.decode_stream(model, p, pay, counts, counts0=table,
                                device=cuda)
    assert np.array_equal(back, syms)
    trained = engine.train_counts(model, p, syms, counts, device=cuda)
    assert torch.equal(trained.cpu(), engine.train_counts(
        model, p, syms, counts, device="cpu"))
    assert kernels.LAUNCHES["unpack_grid"] == 2
    assert kernels.LAUNCHES["pack_grid"] == 1
    assert kernels.LAUNCHES["pack15"] == (1 if name == "qual6" else 0)


# --- the mesh: K13's halves, K18, K19, block workers' streams ---------------

@pytest.mark.parametrize("name", sorted(_TRAIN))
def test_train_split_matches_k13(cuda, name):
    """train_hist over the grids of two halves of a stream into one table,
    then train_rows == K13 over the whole stream, and each half == its
    plain version."""
    model = _TRAIN[name]
    rng = np.random.default_rng(5)
    L = 256
    counts = rng.integers(1, 40, 8 * L).astype(np.int64)
    syms = rng.integers(0, model.alphabet, int(counts.sum())).astype(
        np.uint8)
    ctx = rng.integers(0, 4, len(syms)).astype(np.int32)
    cut = int(counts[:4 * L].sum())

    def grids(cnt, lo, hi):
        lay = make_layout(cnt, L)
        cx = (torch.from_numpy(to_grid(lay, ctx[lo:hi]))
              if isinstance(model, FlatModel) else None)
        return (torch.from_numpy(to_grid(lay, syms[lo:hi])),
                torch.from_numpy(engine._counts_grid(cnt, L)), cx)

    halves = [grids(counts[:4 * L], 0, cut),
              grids(counts[4 * L:], cut, len(syms))]
    h = torch.zeros((model.n_ctx, model.alphabet), dtype=torch.int32)
    hc = h.to(cuda)
    for g, cg, cx in halves:
        kernels.train_hist(g, cg, model, h, cx)
        kernels.train_hist(g.to(cuda), cg.to(cuda), model, hc,
                           None if cx is None else cx.to(cuda))
    assert torch.equal(hc.cpu(), h)
    rows = kernels.train_rows(hc, model)
    assert torch.equal(rows.cpu(), kernels.train_rows(h.clone(), model))
    g, cg, cx = grids(counts, 0, len(syms))
    whole = kernels.train_counts(g.to(cuda), cg.to(cuda), model,
                                 None if cx is None else cx.to(cuda))
    assert torch.equal(rows, whole)


def _frozen_stream(cuda, model, seed=9, R=3000, L=256):
    rng = np.random.default_rng(seed)
    counts, lay, syms, table = _stream(rng, model, R=R, L=L, maxlen=90)
    cum, packed = kernels.quant_pack(torch.from_numpy(table).to(cuda))
    g = torch.from_numpy(to_grid(lay, syms)).to(cuda)
    cg = torch.from_numpy(engine._counts_grid(counts, L)).to(cuda)
    words, emit, states = kernels.frozen_encode_lanes(g, cg, packed, model)
    out, n = kernels.compact_words(words, emit)
    n = int(n.item())
    W = 1024
    while W < n + 8:
        W <<= 1
    wpad = torch.zeros(W, dtype=torch.int16, device=cuda)
    wpad[:n] = out[:n]
    return lay, g, cg, cum, states, wpad


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("model", _MODELS[:2], ids=lambda m: type(m).__name__)
def test_ctx_shard_decode_matches_k4_and_plain(cuda, model, D):
    """K18 with the table in D row shards == K4 on the whole table (the
    stream's symbols) and == its plain version (symbols and final
    states, every lane back at RANS_L); the shards share the card, so
    the stream is one launch."""
    from fastqueeze_tpu_torch.config import RANS_L
    lay, g, cg, cum, states, wpad = _frozen_stream(cuda, model)
    k4 = kernels.frozen_decode(states, wpad, cg, lay.T, cum, model)
    n = model.n_ctx // D
    # separate row blocks, as mesh.shard_tables makes them
    cums = [cum[i * n:(i + 1) * n].clone() for i in range(D)]
    kernels.reset_launch_counts()
    out, x = kernels.ctx_shard_decode(states, wpad, cg, lay.T, cums, model)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ctx_shard_decode"] == 1
    assert torch.equal(out, k4) and torch.equal(out, g)
    assert bool(((x.long() & 0xFFFFFFFF) == RANS_L).all())
    po, px = kernels.ctx_shard_decode_plain(
        states.cpu(), wpad.cpu(), cg.cpu(), lay.T, [c.cpu() for c in cums],
        model)
    assert torch.equal(out.cpu(), po) and torch.equal(x.cpu(), px)


@pytest.mark.parametrize("L", [256, 4500])
@pytest.mark.parametrize("model", _MODELS[:2], ids=lambda m: type(m).__name__)
def test_ctx_shard_steps_match_one_call(cuda, model, L):
    """The wave-at-a-time route that shards on several cards take (two
    groups of two shards, each group's one (1, 3, L) partial summed with
    mesh.psum between the steps), run on one card, == the one-call route
    == K4 (L = 4500: several lanes a thread on both routes)."""
    from fastqueeze_tpu_torch.parallel import mesh as tm
    lay, g, cg, cum, states, wpad = _frozen_stream(
        cuda, model, seed=3, R=3000 if L == 256 else 2 * L, L=L)
    n = model.n_ctx // 4
    cums = [cum[i * n:(i + 1) * n].clone() for i in range(4)]
    want, wx = kernels.ctx_shard_decode(states, wpad, cg, lay.T, cums, model)
    assert torch.equal(want, g)
    runs = [kernels.ShardDecode(states, wpad, cg, lay.T, cums[2 * i:2 * i + 2],
                                model, shard0=2 * i, writer=i == 0)
            for i in range(2)]
    xin = [None, None]
    kernels.reset_launch_counts()
    for t in range(lay.T + 1):
        outs = [r.step(t, x) for r, x in zip(runs, xin)]
        assert all(tuple(o.shape) == (1, 3, L) for o in outs)
        xin = tm.psum(outs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ctx_shard_decode"] == 2 * (lay.T + 1)
    assert torch.equal(runs[0].out, want) and torch.equal(runs[0].x, wx)


@pytest.mark.parametrize("case", [dict(k=14), dict(k=22),
                                  dict(k=14, n_seeds=6, excl_bp=7,
                                       n_cand=64),
                                  dict(k=22, n_seeds=6, excl_bp=7,
                                       n_cand=64, lp=1024)])
@pytest.mark.parametrize("layout", [[[0, 1, 2, 3]], [[0, 1], [2, 3]]],
                         ids=["one_group", "two_groups"])
def test_sharded_align_matches_plain(cuda, case, layout, monkeypatch):
    """K19 through the index-sharded aligner on 4 shards on the card
    == the same call on 4 CPU shards (every phase's plain version):
    mapped, pos, rev and mask; at Lp 128 (the frame words in registers)
    and 1024 (in shared memory, wide keys); a launch a phase and device
    group, the shards all in one group (2 x 3 + the tail) and in the two
    groups that two cards would hold (2 x 3 x 2 + 1; the second group's
    verify on columns from 2 Cs)."""
    from fastqueeze_tpu_torch.align.hash import _gridify
    from fastqueeze_tpu_torch.align.index import build_from_ref
    from fastqueeze_tpu_torch.align.ref import RefSeq
    from fastqueeze_tpu_torch.parallel import mesh as tm
    k, lp = case["k"], case.get("lp", 128)
    al, codes, dege, lengths = _align_fixture(
        k, **({} if lp == 128 else dict(n_reads=200, lens=(300, 1000))))
    rng = np.random.default_rng(41)
    ref = rng.integers(0, 4, 40_000).astype(np.uint8)
    for j in range(40):
        ref[9000 + j * 70:9000 + j * 70 + 60] = ref[:60]
    p = CodecParams(seed_len=k)
    idx = build_from_ref(RefSeq(ref, np.zeros(len(ref), bool), ["r"],
                                np.array([0, len(ref)]), ""), p)
    sh = tm.shard_ref_index(idx, 4)
    c, d = _gridify(codes, dege, lengths, lp)
    kw = {n: case[n] for n in ("n_seeds", "excl_bp", "n_cand") if n in case}
    cpu = torch.device("cpu")
    want = tm.align_blocks_index_sharded(
        tm.Mesh([cpu] * 4, ctx_shards=4), p, sh, c, d, lengths, **kw)
    monkeypatch.setattr(tm, "_device_groups", lambda devs: layout)
    kernels.reset_launch_counts()
    got = tm.align_blocks_index_sharded(
        tm.Mesh([cuda] * 4, ctx_shards=4), p, sh, c, d, lengths, **kw)
    assert kernels.LAUNCHES["sharded_align"] == 2 * 3 * len(layout) + 1
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert want[0].sum() > len(lengths) // 4     # the fixture's mappable


def test_block_worker_launches_on_its_shard_stream(cuda, monkeypatch):
    """device_cycled runs block i under device i % N and a stream of its
    own; a kernel the block launches goes to that stream (not the
    default one), and two shards on one card get two streams."""
    from fastqueeze_tpu_torch.parallel import mesh as tm
    seen = []
    real = kernels._launch

    def spy(fn, name, dev, *args, **kw):
        seen.append((name, torch.cuda.current_stream(dev).cuda_stream))
        return real(fn, name, dev, *args, **kw)

    monkeypatch.setattr(kernels, "_launch", spy)
    table = torch.from_numpy(np.random.default_rng(1).integers(
        1, 40, (256, 4)).astype(np.int32))

    def work(i, item, device):
        cum, _ = kernels.quant_pack(item.to(device))
        return (torch.cuda.current_stream(device).cuda_stream,
                cum.cpu())

    run = tm.device_cycled([cuda, cuda], work)
    outs = [run(i, table) for i in range(4)]
    default = torch.cuda.default_stream(cuda).cuda_stream
    streams = [s for s, _ in outs]
    assert [s for _, s in seen] == streams
    assert default not in streams
    assert streams[0] == streams[2] != streams[1] == streams[3]
    want = kernels.quant_pack(table)[0]
    assert all(torch.equal(c, want) for _, c in outs)


# --- K13's chunked histogram and K4's cluster decode at their split cases --
#
# The same cases as tests/test_torch_chunk_edges.py (which holds the plain
# versions to the JAX engine on the CPU), kernel against plain version.

_EDGE = {
    "seq_o10": SeqModel(alphabet=4, init=3, inc=1, cap=253, order=10),
    "fqz_q2": QualModel(alphabet=41, init=1, inc=8, cap=8192, qlevel=2),
    "chain_k4_drop2": QualModel(alphabet=41, init=1, inc=16, cap=8192, k=4,
                                ctx_base=41, hash_bits=12, pos_bits=3,
                                drop_bits=2),
    "order0": CtxModel(alphabet=256, init=1, inc=16, cap=8192),
    "order1_byte": Order1ByteModel(alphabet=256, init=1, inc=16, cap=8192),
    "flat_4": FlatModel(alphabet=2, init=1, inc=16, cap=8192, n_ctx=4),
}


def _edge_stream(model, L, seed, long_len=3000):
    """(read counts, read-major symbols, flat contexts or None): lane 0
    one read of long_len (23 chunks at C = 128), lanes 1-5 reads that
    cross chunk boundaries at C = 32, 64, 128, end on them and are
    followed by zero-length slots, the rest random with zeros; qualities
    alternate highs and zeros (drops saturate within a chunk) or descend
    slowly (drops carried across chunks)."""
    rng = np.random.default_rng(seed)
    lanes = [[long_len], [31, 2, 40, 63, 65, 1, 127, 129],
             [64, 0, 64, 0, 0, 32, 0, 96, 128, 0, 16],
             [32, 0, 96, 0, 1, 0, 255, 33], [0, 0, 130, 0, 257, 0, 70],
             [5] * 40 + [0, 0, 300]][:L]
    while len(lanes) < L:
        n = int(rng.integers(2, 12))
        lens = rng.integers(0, 150, n)
        lens[rng.random(n) < 0.3] = 0
        lanes.append(list(lens))
    J = max(len(x) for x in lanes)
    counts = np.zeros(J * L, np.int64)
    for lane, lens in enumerate(lanes):
        counts[lane:lane + len(lens) * L:L] = lens
    n = int(counts.sum())
    if isinstance(model, QualModel):
        parts = []
        for r, c in enumerate(counts[counts > 0]):
            if r % 2:
                parts.append(np.where(np.arange(c) % 2, 0, 40))
            else:
                parts.append(np.clip(40 - np.arange(c) // 9
                                     + rng.integers(-1, 2, c), 0, 40))
        syms = np.concatenate(parts).astype(np.uint8)
    else:
        syms = rng.integers(0, model.alphabet, n).astype(np.uint8)
    ctx = (rng.integers(0, 4, n).astype(np.int32)
           if isinstance(model, FlatModel) else None)
    return counts, syms, ctx


def _edge_grids(model, L, seed, long_len=3000):
    counts, syms, ctx = _edge_stream(model, L, seed, long_len)
    lay = make_layout(counts, L)
    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(engine._counts_grid(counts, L))
    cx = None if ctx is None else torch.from_numpy(to_grid(lay, ctx))
    return g, cg, cx


@pytest.mark.parametrize("name", sorted(_EDGE))
def test_train_chunk_edges_match_plain(cuda, name):
    """K13 and its histogram half == their plain versions on reads that
    cross the kernel's 64-wave chunks, zero-length and long reads (every
    model kind; the raw histogram compared before the cap rescale could
    hide a difference)."""
    model = _EDGE[name]
    g, cg, cx = _edge_grids(model, 256, 3)
    dev = (g.to(cuda), cg.to(cuda), None if cx is None else cx.to(cuda))
    zeros = torch.zeros((model.n_ctx, model.alphabet), dtype=torch.int32)
    want = kernels.train_hist(g, cg, model, zeros.clone(), cx)
    kernels.reset_launch_counts()
    got = kernels.train_hist(*dev[:2], model, zeros.to(cuda), dev[2])
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) == model.inc * int(cg.sum())
    whole = kernels.train_counts(dev[0], dev[1], model, dev[2])
    assert torch.equal(whole.cpu(), kernels.train_rows(want.clone(), model))
    assert kernels.LAUNCHES["train_hist"] == 1
    assert kernels.LAUNCHES["train_counts"] == 1


@pytest.mark.parametrize("name", ["seq_o10", "fqz_q2", "flat_4"])
def test_train_split_long_reads_two_grids(cuda, name):
    """train_hist over two grids of long reads into one table ==
    the plain version's table, then train_rows == the plain trainer."""
    model = _EDGE[name]
    h = torch.zeros((model.n_ctx, model.alphabet), dtype=torch.int32)
    hc = h.clone().to(cuda)
    for seed in (4, 5):
        g, cg, cx = _edge_grids(model, 64, seed, long_len=5000)
        kernels.train_hist(g, cg, model, h, cx)
        kernels.train_hist(g.to(cuda), cg.to(cuda), model, hc,
                           None if cx is None else cx.to(cuda))
    assert torch.equal(hc.cpu(), h)
    assert torch.equal(kernels.train_rows(hc, model).cpu(),
                       kernels.train_rows(h.clone(), model))


_ROW_MODELS = {
    4: SeqModel(alphabet=4, init=3, inc=1, cap=253, order=10),
    41: QualModel(alphabet=41, init=1, inc=8, cap=8192, qlevel=2),
    48: QualModel(alphabet=48, init=1, inc=8, cap=8192, qlevel=2),
}


def _row_partials(model, nb: int, n: int, seed: int):
    """nb raw (n, A) partials, the first with edge rows (zeros, a total
    of cap after init, one over, one that needs all 24 halvings, its
    int64 total past int32) at its first and last four rows and the
    others zero there."""
    A, init, cap = model.alphabet, model.init, model.cap
    rng = np.random.default_rng(seed)
    parts = [rng.integers(0, 300, (n, A)).astype(np.int32)
             for _ in range(nb)]
    at = np.zeros(A, np.int64)
    at[0] = cap - A * init
    deep = np.full(A, -(-(cap << 23) // A) + 1 - init, np.int64)
    one = np.eye(A, dtype=np.int64)[0]
    edges = np.stack([np.zeros(A, np.int64), at, at + one, deep])
    for k, p in enumerate(parts):
        p[:4] = p[-4:] = edges if k == 0 else 0
    return [torch.from_numpy(p) for p in parts]


@pytest.mark.parametrize("nb", [1, 2, 4])
@pytest.mark.parametrize("A", sorted(_ROW_MODELS))
def test_row_pass_sum_matches_plain(cuda, A, nb):
    """The row pass over nb partials (train_rows_sum) == its plain version
    on the edge rows and on row counts around the lane groups' blocks, on
    16-byte aligned tables and on tables that are not (4-byte pieces:
    the generic path, and A = 41's); nb = 1 in place (train_rows) ==
    the same."""
    model = _ROW_MODELS[A]
    for n in (8, 1027, 1 << 16):
        parts = _row_partials(model, nb, n, seed=A * nb + n)
        want = kernels.train_rows_sum(parts, model)
        kernels.reset_launch_counts()
        got = kernels.train_rows_sum([p.to(cuda) for p in parts], model)
        assert kernels.LAUNCHES["train_rows_sum"] == 1
        assert torch.equal(got.cpu(), want)
        # the same partials one int32 past a 16-byte boundary: the
        # generic path (4-byte pieces)
        shifted = []
        for p in parts:
            buf = torch.zeros(p.numel() + 1, dtype=torch.int32, device=cuda)
            shifted.append(buf[1:].view(p.shape))
            shifted[-1].copy_(p)
        assert torch.equal(kernels.train_rows_sum(shifted, model).cpu(),
                           want)
        if nb == 1:
            inplace = parts[0].to(cuda)
            assert kernels.train_rows(inplace, model) is inplace
            assert torch.equal(inplace.cpu(), want)


def test_row_pass_wrappers_raise_on_bad_input(cuda):
    model = _ROW_MODELS[41]
    part = torch.zeros((16, 41), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shape mismatch"):
        kernels.train_rows_sum([part, part[:8]], model)
    with pytest.raises(ValueError, match="1-64 partials"):
        kernels.train_rows_sum([part] * 65, model)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.train_rows(part[:, :1], model)


def test_cli_profile_on_the_card_names_the_kernels(cuda, tmp_path):
    """--profile on the card: the trace holds CUDA kernel records that
    name the port's kernels (the __global__ functions of csrc/), inside
    the command's span; the archive equals the one written without it."""
    import json
    import os
    import re

    from fastqueeze_tpu_torch import cli
    rng = np.random.default_rng(18)
    fq = str(tmp_path / "in.fq")
    with open(fq, "wb") as fh:
        for r in range(2000):
            seq = bytes(b"ACGT"[c] for c in rng.integers(0, 4, 100))
            qual = bytes((rng.integers(2, 40, 100) + 33).astype(np.uint8))
            fh.write(b"@r.%d\n%s\n+\n%s\n" % (r, seq, qual))
    prof = str(tmp_path / "prof")
    for out, extra in (("a.fqz", []), ("b.fqz", ["--profile", prof])):
        assert cli.main(["-c", "-1", fq, "-o", str(tmp_path / out)]
                        + extra) == 0
    assert ((tmp_path / "a.fqz").read_bytes()
            == (tmp_path / "b.fqz").read_bytes())
    csrc = os.path.join(os.path.dirname(kernels.__file__), "..", "csrc")
    names = set()
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f)) as fh:
            names |= set(re.findall(r"__global__ void (?:__launch_bounds__"
                                    r"\([^)]*\)\s*)?(\w+)", fh.read()))
    with open(os.path.join(prof, cli.TRACE_NAME)) as fh:
        events = json.load(fh)["traceEvents"]
    span = [e for e in events if e.get("name") == cli.RUN_SPAN
            and e.get("cat") == "user_annotation"]
    ours = [e for e in events if e.get("cat") == "kernel"
            and any(re.search(rf"\b{n}\b", e.get("name", ""))
                    for n in names)]
    assert len(span) == 1 and ours
    lo, hi = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    assert all(lo <= e["ts"] <= hi for e in ours)


@pytest.mark.parametrize("L", [1, 3, 64, 4097])
@pytest.mark.parametrize("model", _MODELS[:2], ids=lambda m: type(m).__name__)
def test_frozen_decode_edge_lanes_match_plain(cuda, model, L):
    """K4 == its plain version at lane counts that are not a multiple of
    a cluster's threads, lanes ending at different waves, zero-length
    slots; and on the same payload with its word count cut (the W - 1
    clamp)."""
    rng = np.random.default_rng(L)
    counts, lay, syms, table = _stream(rng, model, R=2 * L + 3, L=L,
                                       maxlen=70)
    p = CodecParams()
    pay = engine.encode_stream(model, p, syms, counts, counts0=table,
                               n_lanes=L, device="cpu")
    kernels.reset_launch_counts()
    back = engine.decode_stream(model, p, pay, counts, counts0=table,
                                device=cuda)
    assert np.array_equal(back, syms)
    assert kernels.LAUNCHES["frozen_decode"] == 1
    cut = bytearray(pay)
    n_words = int.from_bytes(cut[8:12], "little")
    cut[8:12] = (n_words // 3).to_bytes(4, "little")
    cut = bytes(cut[:16 + 4 * L + 2 * (n_words // 3)])
    want = engine.decode_stream(model, p, cut, counts, counts0=table,
                                device="cpu")
    got = engine.decode_stream(model, p, cut, counts, counts0=table,
                               device=cuda)
    torch.cuda.synchronize()
    assert np.array_equal(got, want)


def _decode_inputs(cuda, model, L, R, maxlen, seed, table=None):
    """A stream encoded on the card (K1 -> K2 -> K3) and its padded words:
    (layout, symbol grid, counts grid, cum table, states, words)."""
    rng = np.random.default_rng(seed)
    counts, lay, syms, t = _stream(rng, model, R=R, L=L, maxlen=maxlen)
    if table is None:
        table = torch.from_numpy(t).to(cuda)
    cum, packed = kernels.quant_pack(table)
    g = torch.from_numpy(to_grid(lay, syms)).to(cuda)
    cg = torch.from_numpy(engine._counts_grid(counts, L)).to(cuda)
    words, emit, states = kernels.frozen_encode_lanes(g, cg, packed, model)
    out, n = kernels.compact_words(words, emit)
    n = int(n.item())
    W = 1024
    while W < n + 8:
        W <<= 1
    wpad = torch.zeros(W, dtype=torch.int16, device=cuda)
    wpad[:n] = out[:n]
    return lay, g, cg, cum, states, wpad


def test_frozen_decode_65536_lanes_match_plain(cuda):
    """K4 at the format's 2^16 lanes (8 lanes a thread, their state in
    scratch), small T: == its plain version and the encoded symbols."""
    model = QualModel(alphabet=16, k=3, ctx_base=16, pos_bits=2,
                      drop_bits=2)
    lay, g, cg, cum, states, wpad = _decode_inputs(cuda, model, 1 << 16,
                                                   3 << 16, 30, 12)
    shape = kernels.frozen_decode_shape(1 << 16, model, cuda)
    assert (shape["ctas"], shape["threads"], shape["lanes_per_thread"]) == (
        8, 1024, 8)
    assert shape["max_active_clusters"] >= 1
    got = kernels.frozen_decode(states, wpad, cg, lay.T, cum, model)
    want = kernels.frozen_decode_plain(states, wpad, cg, lay.T, cum, model)
    assert torch.equal(got, want) and torch.equal(got, g)


def test_frozen_decode_q3_table_matches_plain(cuda):
    """K4 on a --qlevel 3 quality table (2^20 rows x 42 u16 cum entries,
    88 MB, past the card's 50 MB L2): == its plain version and the
    encoded symbols; the default lane count runs one lane a thread on a
    cluster of 8 CTAs."""
    from fastqueeze_tpu_torch.models.base import qual_model_for
    model = qual_model_for(CodecParams(qlevel=3), 41)
    rng = np.random.default_rng(13)
    table = torch.from_numpy(rng.integers(
        1, 400, (model.n_ctx, 41)).astype(np.int32)).to(cuda)
    lay, g, cg, cum, states, wpad = _decode_inputs(cuda, model, 512, 3000,
                                                   100, 14, table)
    assert cum.numel() * 2 > 50 << 20
    got = kernels.frozen_decode(states, wpad, cg, lay.T, cum, model)
    want = kernels.frozen_decode_plain(states, wpad, cg, lay.T, cum, model)
    assert torch.equal(got, want) and torch.equal(got, g)
    shape = kernels.frozen_decode_shape(4096, model, cuda)
    assert (shape["ctas"], shape["threads"], shape["lanes_per_thread"]) == (
        8, 512, 1)


# --- K2's chunk-parallel forward pass, K12's cluster under each snapshot ---

def _lanes_stream(model, L, seed, t_pad=8):
    """(read counts, layout at t_pad, symbols): three reads a lane of
    0-149 symbols (every seventh 0) and a first read of 721, so T is under
    1,024; qualities drift, so contexts repeat and drops cross their
    thresholds."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 150, 3 * L).astype(np.int64)
    counts[::7] = 0
    counts[0] = 721
    lay = make_layout(counts, L, t_pad=t_pad)
    assert lay.T < 1024
    n = int(counts.sum())
    if isinstance(model, QualModel):
        syms = np.clip(np.cumsum(rng.integers(-3, 3, n)) % 60 - 10, 0,
                       model.alphabet - 1)
    else:
        syms = rng.integers(0, model.alphabet, n)
    return counts, lay, syms.astype(np.uint8)


@pytest.mark.parametrize("L", [4096, 1000, 9000])
@pytest.mark.parametrize("name", ["seq_o10", "fqz_q2", "chain_k4_drop2"])
def test_frozen_encode_chunks_match_plain(cuda, name, L):
    """K2 (the chunk walk's forward pass, the staged reverse pass) == its
    plain version (words, emit, final states) at L = 4096, 1000 (not a
    multiple of 32) and 9000, T not a multiple of 64, reads crossing the
    64-wave chunks, zero-length slots; one launch a call."""
    model = _EDGE[name]
    counts, lay, syms = _lanes_stream(model, L, L)
    assert lay.T % 64
    rng = np.random.default_rng(L)
    table = torch.from_numpy(rng.integers(
        0, 300, (model.n_ctx, model.alphabet)).astype(np.int32))
    packed = kernels.quant_pack_plain(table)[1]
    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(engine._counts_grid(counts, L))
    want = kernels.frozen_encode_lanes(g, cg, packed, model)
    kernels.reset_launch_counts()
    got = kernels.frozen_encode_lanes(g.to(cuda), cg.to(cuda),
                                      packed.to(cuda), model)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert kernels.LAUNCHES["frozen_encode_lanes"] == 1


def _overcap(model, table):
    """The table with its first and last rows of total 2^21 (over cap
    after every boundary's halvings)."""
    big = table.clone()
    big[0] = (1 << 21) // model.alphabet
    big[model.n_ctx - 1] = (1 << 21) // model.alphabet
    return big


@pytest.mark.parametrize("chunk", [16, "T"])
@pytest.mark.parametrize("name", ["seq_o10", "fqz_q3"])
def test_semi_encode_boundaries_match_plain(cuda, name, chunk):
    """K11 (the chunk walk's context grid, then per chunk a boundary over
    the last chunk's rows and the over-cap rows, and the slots' pass) ==
    its plain version (sf, final counts) on seq and quality (A = 40)
    tables, at chunk 16 and chunk = T, from init, from a table K13 trains
    and from that table with two rows over cap; one launch a call."""
    model = _SEMI[name]
    L = 1000
    counts, lay, syms = _lanes_stream(model, L, 7 + len(name), t_pad=16)
    T = lay.T
    chunk = T if chunk == "T" else chunk
    assert T % chunk == 0
    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(engine._counts_grid(counts, L))
    gc, cgc = g.to(cuda), cg.to(cuda)
    nh = engine._n_halve_chunk(model, L, chunk)
    trained = kernels.train_counts(gc.flip(0).contiguous(), cgc, model)
    for c0 in (None, trained, _overcap(model, trained)):
        want = kernels.semi_encode_walk(g, cg, model, nh, chunk,
                                        None if c0 is None else c0.cpu())
        kernels.reset_launch_counts()
        got = kernels.semi_encode_walk(gc, cgc, model, nh, chunk, c0)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["semi_encode_walk"] == 1
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("L", [4096, 1000, 9000])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("name", ["seq_o10", "fqz_q3"])
def test_semi_decode_cluster_matches_plain(cuda, name, chunk, L):
    """K12 (K4's cluster under each chunk's snapshot) == its plain version
    (symbols, final counts) from init, from a table K13 trains and from
    an over-cap counts0, at L = 4096 (one lane a thread), 1000 and 9000
    (two lanes a thread), chunks 16 (T not a multiple of 64) and 64; also
    on the payload cut to a third of its words in a buffer of that size
    (reads clamp at W - 1); one launch a call; the cluster's shape."""
    model = _SEMI[name]
    counts, lay, syms = _lanes_stream(model, L, L + chunk, t_pad=chunk)
    T = lay.T
    assert T % chunk == 0 and (chunk == 64 or T % 64)
    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(engine._counts_grid(counts, L))
    gc, cgc = g.to(cuda), cg.to(cuda)
    nh = engine._n_halve_chunk(model, L, chunk)
    trained = kernels.train_counts(gc.flip(0).contiguous(), cgc, model)
    for c0 in (None, trained, _overcap(model, trained)):
        c0_p = None if c0 is None else c0.cpu()
        sf, _ = kernels.semi_encode_walk(gc, cgc, model, nh, chunk, c0)
        words_e, emit, states = kernels.rans_encode_sf(sf, cgc)
        out, n = kernels.compact_words(words_e, emit)
        k = int(n.item())
        W = 1024
        while W < k + 8:
            W <<= 1
        full = torch.zeros(W, dtype=torch.int16)
        full[:k] = out[:k].cpu()
        for words in (full, full[:k // 3].clone()):
            want = kernels.semi_decode(states.cpu(), words, cg, T, model, nh,
                                       chunk, c0_p)
            kernels.reset_launch_counts()
            got = kernels.semi_decode(states, words.to(cuda), cgc, T, model,
                                      nh, chunk, c0)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["semi_decode"] == 1
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])
            assert torch.equal(want[0], g) == (words.numel() == W)
    shape = kernels.semi_decode_shape(L, model, cuda)
    assert shape["ctas"] == 8 and shape["max_active_clusters"] >= 1
    assert shape["lanes_per_thread"] == (2 if L > 8 * 512 else 1)


# --- K7's reverse chain (shared with K2's reverse pass), K3's one pass ------

def _sf_edges(kind, T, L, seed):
    """A (T, L) sf grid of valid words (start | end << 16, 0 at padding)
    and its (1, L) lane lengths: "freq1" (f = 1 at 60% of slots),
    "freq16384" (f = 2^14, start 0, at 60%), "freq0" (zero-frequency
    symbols at 20%) or "mixed"; lanes of length 0, T, T - 1, 1, 23, 24,
    25, random, and the last lanes T, 0, T."""
    rng = np.random.default_rng(seed)
    M = 1 << 14
    f = rng.integers(1, 300, (T, L))
    pick = rng.random((T, L))
    if kind == "freq1":
        f[pick < 0.6] = 1
    elif kind == "freq16384":
        f[pick < 0.6] = M
    elif kind == "freq0":
        f[pick < 0.2] = 0
    else:
        f[pick < 0.2] = 1
        f[(pick >= 0.2) & (pick < 0.3)] = M
        f[(pick >= 0.3) & (pick < 0.35)] = 0
        f[pick > 0.9] = rng.integers(8000, M, int((pick > 0.9).sum()))
    start = (rng.random((T, L)) * (M - f + 1)).astype(np.int64)
    sf = start | ((start + f) << 16)
    n = rng.integers(0, T + 1, L)
    n[:7] = [0, T, T - 1, 1, 23, 24, 25]
    n[-3:] = [T, 0, T]
    n = np.minimum(n, T)
    sf[np.arange(T)[:, None] >= n[None, :]] = 0
    return (torch.from_numpy(sf.astype(np.uint32).view(np.int32)),
            torch.from_numpy(n[None, :].astype(np.int32)))


@pytest.mark.parametrize("L, T", [(37, 1), (37, 23), (37, 25), (37, 100),
                                  (2048, 100), (2048, 3072)])
@pytest.mark.parametrize("kind", ["freq1", "freq16384", "freq0", "mixed"])
def test_rans_encode_sf_edges_match_plain(cuda, kind, L, T):
    """K7 == its plain version (words, 0 at padding; emit; final states)
    on grids of freq 1, 2^14 (the identity step) and 0, lanes of length
    0 and T, a warp and a part (L = 37) and 2048 lanes, T below, around
    and not a multiple of 24; one launch a call."""
    sf, cg = _sf_edges(kind, T, L, seed=T + L)
    want = kernels.rans_encode_sf(sf, cg)
    kernels.reset_launch_counts()
    got = kernels.rans_encode_sf(sf.to(cuda), cg.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rans_encode_sf"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("walk", ["adapt", "semi"])
@pytest.mark.parametrize("name", ["seq_o10", "fqz_q3"])
def test_rans_encode_sf_on_walk_sf_matches_plain(cuda, name, walk):
    """K7 on the sf K5 (the adaptive walk) or K11 (the semi-adaptive walk,
    chunk 16) writes on the card, at L = 1000 (not a multiple of 32) with
    ragged reads, == its plain version on the same sf; K3 on its words ==
    its plain version."""
    model = _SEMI[name]
    L = 1000
    counts, lay, syms = _lanes_stream(model, L, 5 + len(name), t_pad=16)
    gc = torch.from_numpy(to_grid(lay, syms)).to(cuda)
    cgc = torch.from_numpy(engine._counts_grid(counts, L)).to(cuda)
    if walk == "adapt":
        sf = kernels.adapt_encode_walk(gc, cgc, model,
                                       engine._n_halve(model, L))
    else:
        sf = kernels.semi_encode_walk(
            gc, cgc, model, engine._n_halve_chunk(model, L, 16), 16)[0]
    got = kernels.rans_encode_sf(sf, cgc)
    want = kernels.rans_encode_sf_plain(sf, cgc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out, n = kernels.compact_words(*got[:2])
    out_p, n_p = kernels.compact_words_plain(*want[:2])
    k = int(n_p.item())
    assert int(n.item()) == k and torch.equal(out[:k], out_p[:k])


@pytest.mark.parametrize("L", [37, 100])
@pytest.mark.parametrize("name", ["seq_o10", "fqz_q2"])
def test_frozen_encode_reverse_edges_match_plain(cuda, name, L):
    """K2 (its reverse pass is K7's chain) == its plain version on a warp
    and a part (L = 37) and on 100 lanes, a lane of no symbols, reads
    crossing chunks, a table with zero counts (zero-frequency
    symbols)."""
    model = _EDGE[name]
    counts, lay, syms = _lanes_stream(model, L, L + 3)
    counts[L - 1::L] = 0                      # the last lane's reads: none
    lay = make_layout(counts, L, t_pad=8)
    syms = syms[:int(counts.sum())]
    rng = np.random.default_rng(L)
    table = torch.from_numpy(rng.integers(
        0, 4, (model.n_ctx, model.alphabet)).astype(np.int32))
    packed = kernels.quant_pack_plain(table)[1]
    g = torch.from_numpy(to_grid(lay, syms))
    cg = torch.from_numpy(engine._counts_grid(counts, L))
    want = kernels.frozen_encode_lanes(g, cg, packed, model)
    got = kernels.frozen_encode_lanes(g.to(cuda), cg.to(cuda),
                                      packed.to(cuda), model)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _flags(case, n, rng):
    if case == "none":
        return np.zeros(n, np.uint8)
    if case == "all":
        return np.ones(n, np.uint8)
    if case == "any_byte":
        e = rng.integers(0, 256, n).astype(np.uint8)
        e[rng.random(n) < 0.5] = 0
        return e
    return (rng.random(n) < 0.5).astype(np.uint8)


@pytest.mark.parametrize("n", [0, 1, 100, 4095, 4096, 4097, 12287, 12289,
                               163_963])
@pytest.mark.parametrize("case", ["none", "all", "half", "any_byte"])
def test_compact_words_edges_match_plain(cuda, case, n):
    """K3 (one pass, a decoupled look-back) == its plain version (the
    dense prefix, the count) at n = 0, below a tile, tile multiples of
    4096 and +- 1, 40 tiles + 123; flags from none to all and nonzero
    bytes other than 1; also on views one slot in (not 16-byte aligned:
    the scalar loads); one launch a call."""
    rng = np.random.default_rng(n + len(case))
    words = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, n + 1)
                             .astype(np.int16))
    emit = torch.from_numpy(_flags(case, n + 1, rng))
    wc, ec = words.to(cuda), emit.to(cuda)
    for at in (0, 1):
        view = slice(at, at + n)
        out_p, n_p = kernels.compact_words(words[view].reshape(1, n),
                                           emit[view].reshape(1, n))
        kernels.reset_launch_counts()
        out, cnt = kernels.compact_words(wc[view].reshape(1, n),
                                         ec[view].reshape(1, n))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["compact_words"] == 1
        k = int(n_p.item())
        assert int(cnt.item()) == k
        assert torch.equal(out[:k].cpu(), out_p[:k])


def test_compact_words_frozen_grid_matches_plain(cuda):
    """K3 on a 25.2 M-slot grid (L = 4096, T = 6144, the frozen shape)
    with 35% of flags set == its plain version and torch.masked_select,
    twice (the ticket and descriptors start from zero each call)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    words = torch.randint(-(1 << 15), 1 << 15, (6144, 4096), device=cuda,
                          dtype=torch.int16, generator=g)
    emit = (torch.rand((6144, 4096), device=cuda, generator=g)
            < 0.35).to(torch.uint8)
    want, n_p = kernels.compact_words_plain(words, emit)
    k = int(n_p.item())
    assert torch.equal(torch.masked_select(words, emit.bool()), want[:k])
    for _ in range(2):
        out, cnt = kernels.compact_words(words, emit)
        assert int(cnt.item()) == k and torch.equal(out[:k], want[:k])


# --- the frozen trainer's card scorer: K20, narrow_rows, K13 with inc --------

def _nll_case(rng, dtype, n_rows, A, hi):
    c = rng.integers(0, hi, (n_rows, A)).astype(dtype)
    c[:2, :3] = 0
    h = rng.integers(0, 5, (n_rows, A)).astype(np.int32)
    h[h < 3] = 0
    h[5:40] = 0
    t = torch.from_numpy(c.view(np.int16) if dtype == np.uint16 else c)
    return c, t, torch.from_numpy(h)


@pytest.mark.parametrize("mbits", [0, 3, 2])
@pytest.mark.parametrize("dtype, n_rows, A, hi", [
    (np.uint8, 1 << 20, 4, 254), (np.uint16, 65536, 40, 9000),
    (np.uint16, 4099, 41, 9000), (np.int32, 1 << 18, 40, 1 << 17),
    (np.uint16, 3, 8, 100), (np.uint16, 0, 40, 100)])
def test_hist_nll_matches_plain(cuda, dtype, n_rows, A, hi, mbits):
    """K20 == its plain version bit for bit (terms and stat), on tables of
    every count type, row counts across tiles and an empty table; the
    terms' np.sum == frozen._hist_nll_bits; a histogram one int32 past a
    16-byte boundary (scalar loads) gives the same."""
    from fastqueeze_tpu_torch.pipeline import frozen
    rng = np.random.default_rng(n_rows + A + mbits)
    c, t, h = _nll_case(rng, dtype, n_rows, A, hi)
    tab = frozen._log2_table(int(kernels._table_u64(t).sum(1).max()) + 1
                             if n_rows else 1, "cpu")
    cap = max(1, int(np.count_nonzero(h.numpy())))
    want, wstat = kernels.hist_nll(t, h, tab, mbits, cap)
    kernels.reset_launch_counts()
    got, gstat = kernels.hist_nll(t.to(cuda), h.to(cuda), tab.to(cuda),
                                  mbits, cap)
    assert kernels.LAUNCHES["hist_nll"] == 2
    n = int(wstat[0])
    assert torch.equal(gstat.cpu(), wstat)
    assert torch.equal(got[:n].cpu(), want[:n])
    b = c if mbits == 0 else frozen._mant_bucket(c, mbits).astype(c.dtype)
    assert float(np.sum(got[:n].cpu().numpy())) == frozen._hist_nll_bits(
        b, h.numpy())
    buf = torch.zeros(h.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = buf[1:].view(h.shape)
    shifted.copy_(h)
    got2, gstat2 = kernels.hist_nll(t.to(cuda), shifted, tab.to(cuda),
                                    mbits, cap)
    assert torch.equal(gstat2, gstat) and torch.equal(got2[:n], got[:n])


def test_hist_nll_keeps_to_its_room(cuda):
    """Fewer terms' room than nonzero cells: the count is the whole
    count, the first room terms are written and none past them."""
    rng = np.random.default_rng(3)
    _, t, h = _nll_case(rng, np.uint16, 5000, 40, 9000)
    from fastqueeze_tpu_torch.pipeline import frozen
    tab = frozen._log2_table(9000 * 40, cuda)
    full, stat = kernels.hist_nll(t.to(cuda), h.to(cuda), tab, 0)
    n = int(stat[0].item())
    part, pstat = kernels.hist_nll(t.to(cuda), h.to(cuda), tab, 0, n // 2)
    assert int(pstat[0].item()) == n and part.numel() == n // 2
    assert torch.equal(part, full[:n // 2])


@pytest.mark.parametrize("width, step", [(1, 1), (2, 1), (2, 8), (4, 1),
                                         (4, 8), (1, 3)])
def test_narrow_rows_matches_plain(cuda, width, step):
    rng = np.random.default_rng(width * 10 + step)
    c = torch.from_numpy(rng.integers(0, 1 << 18, (70001, 41)).astype(
        np.int32))
    want = kernels.narrow_rows(c, width, step)
    got = kernels.narrow_rows(c.to(cuda), width, step)
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("inc", [8, 16, 24])
@pytest.mark.parametrize("A", sorted(_ROW_MODELS))
def test_row_pass_with_inc_matches_plain(cuda, A, inc):
    """The row pass weighing raw counts by inc (the card scorer's alphas)
    == its plain version and frozen._cap_rescale, in place and over two
    partials."""
    from fastqueeze_tpu_torch.pipeline import frozen
    model = _ROW_MODELS[A]
    parts = _row_partials(model, 2, 1027, seed=A + inc)
    parts = [p // inc for p in parts]
    want = kernels.train_rows_sum(parts, model, inc)
    got = kernels.train_rows_sum([p.to(cuda) for p in parts], model, inc)
    assert torch.equal(got.cpu(), want)
    rescaled = frozen._cap_rescale(
        dataclasses.replace(model, inc=inc), (parts[0] + parts[1]).numpy())
    assert np.array_equal(want.numpy(), rescaled)
    one = (parts[0] + parts[1]).to(cuda)
    assert torch.equal(kernels.train_rows(one, model, inc).cpu(), want)


def _bench_reads(seed, n, **kw):
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from fqbench import gen
    reads = dict(kind="se", length=100, genome_bp=10_000_000,
                 sub_rate=0.01, n_rate=0.001, qual_states=40, ids="sra")
    reads.update(kw)
    return gen.make_files(seed, n, reads)


def test_card_grids_give_the_native_histograms(cuda):
    """The card scorer's K13 histograms over its even and odd lane grids
    == native.qctx_hist's full and odd-half histograms (the host scorer's)
    for the fqz formula and every rank-chain candidate of 40 quality
    values, at a stride-sampled prefix of 100,000 reads."""
    from fastqueeze_tpu_torch.io import native
    from fastqueeze_tpu_torch.io.fastq import parse_block
    from fastqueeze_tpu_torch.pipeline import frozen
    b = parse_block(_bench_reads(4, 100_000)[0].tobytes(), True)
    qvals, lut = frozen.qual_vocab(b.qual_flat)
    A = frozen._qual_alphabet(len(qvals) - 1)
    stride = 3
    keep = frozen._sample_keep(b.n_reads, stride)
    qs = lut[b.qual_flat[np.repeat(keep, b.lengths)]]
    sc = frozen._CardScorer(CodecParams(), QualModel(alphabet=A),
                            np.zeros((1, A), np.int32), lambda: qs,
                            b.lengths[keep], True, 1.0, 2.0, cuda)
    for k, db, pb, hb in [(0, 0, 0, 0)] + frozen._qctx_candidates(
            len(qvals)):
        m = QualModel(alphabet=A, qlevel=2, k=k, ctx_base=len(qvals),
                      drop_bits=db, pos_bits=pb, hash_bits=hb)
        full, odd = native.qctx_hist(
            b.qual_flat, b.lengths, stride, lut, A, k, m.ctx_base or 1, db,
            pb, m.drop_init, hash_bits=hb, qlevel=m.qlevel, n_ctx=m.n_ctx,
            holdout=True)
        hA = sc._hist(m, sc.grids[:1]).cpu().numpy()
        hB = sc._hist(m, sc.grids[1:]).cpu().numpy()
        assert np.array_equal(hB, odd), (k, db, pb, hb)
        assert np.array_equal(hA + hB, full), (k, db, pb, hb)


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_card_scorer_archive_is_the_host_ones(cuda, tmp_path, kind,
                                              monkeypatch):
    """A two-block compress on the card (its candidates scored there)
    and with the host scorer: the same SHA-256, the same costs in the
    same order, every score counted on its side; the archive decodes."""
    import hashlib

    from fastqueeze_tpu_torch.pipeline import driver, frozen, pe
    from fastqueeze_tpu_torch.utils.metrics import DebugInfo
    n = 30_000
    files = (_bench_reads(8, n) if kind == "se" else _bench_reads(
        8, n, kind="pe", insert_min=200, insert_max=500))
    paths = []
    for i, f in enumerate(files):
        paths.append(str(tmp_path / f"in_{i}.fq"))
        with open(paths[-1], "wb") as fh:
            fh.write(f.tobytes())
    block = files[0].size // 2 + 1000
    out, costs, dbgs = {}, {}, {}
    for card in (True, False):
        monkeypatch.setattr(frozen, "_TRAIN_CACHE", {})
        monkeypatch.setattr(frozen, "_scores_on_card", lambda d, c=card: c)
        cls = frozen._CardScorer if card else frozen._HostScorer
        score = cls.score
        costs[card] = []

        def kept(self, model, hists, _s=score, _c=costs[card]):
            r = _s(self, model, hists)
            _c.append(r[0])
            return r

        monkeypatch.setattr(cls, "score", kept)
        p = CodecParams(use_model=1, model_train_mb=3, block_bytes=block)
        arc = str(tmp_path / f"{kind}_{card}.fqz")
        dbgs[card] = DebugInfo()
        if kind == "se":
            r = driver.compress_se(p, paths[0], arc, dbg=dbgs[card],
                                   device=cuda)
        else:
            r = pe.compress_pe(p, paths[0], paths[1], arc, dbg=dbgs[card],
                               device=cuda)
        assert r["blocks"] >= 2
        monkeypatch.setattr(cls, "score", score)
        with open(arc, "rb") as fh:
            out[card] = hashlib.sha256(fh.read()).hexdigest()
    assert out[True] == out[False]
    assert costs[True] == costs[False] and costs[True]
    assert dbgs[True].vals["qctx_card_scores"] == len(costs[True])
    assert "qctx_host_scores" not in dbgs[True].vals
    assert dbgs[False].vals["qctx_host_scores"] == len(costs[False])
    assert "qctx_card_scores" not in dbgs[False].vals
    back = driver.decompress(str(tmp_path / f"{kind}_True.fqz"),
                             str(tmp_path / "back"), device=cuda)
    for got, want in zip(back, paths):
        with open(got, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()
