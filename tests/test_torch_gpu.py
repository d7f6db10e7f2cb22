"""CUDA kernels of fastqueeze_tpu_torch against their plain PyTorch versions.

These run only on a machine with a CUDA card (they skip elsewhere):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(--noconftest: tests/conftest.py sets up JAX, which these tests do not
use.)  Integer kernels, so every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.models.base import QualModel, SeqModel
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
                                         counts0=table, n_lanes=64))
    n_words = int.from_bytes(pay[8:12], "little")
    pay[8:12] = (n_words // 3).to_bytes(4, "little")
    pay = bytes(pay[:16 + 4 * 64 + 2 * (n_words // 3)])
    want = engine.decode_stream(model, p, pay, counts, counts0=table)
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
