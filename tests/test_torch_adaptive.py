"""fastqueeze_tpu_torch's adaptive coder against fastqueeze_tpu's.

On the CPU the K5/K7/K6 wrappers take their plain PyTorch versions; these
tests hold them, through the port's engine, to the JAX engine's adaptive
path on the same seeded inputs, bit for bit: payload bytes of
encode_stream(adapt=True) and the symbols of decode_stream, for every
model kind (seq, fqz quality at qlevel 2 and 3, a hashed rank chain,
order-1 byte, flat with a ctx grid, order-0 binary), with zero-length
reads; the pinned payload MD5s of tests/test_engine.py; the context
models' vectorized grids against their lane walk; the semi-adaptive walk
and a counts0 start through the engine; the refusals (over-cap initial
rows) and the native-coder routing.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.config import CodecParams as JParams
from fastqueeze_tpu.models import base as jb
from fastqueeze_tpu.ops import engine as je
from fastqueeze_tpu_torch.config import CodecParams
from fastqueeze_tpu_torch.models import base as tb
from fastqueeze_tpu_torch.ops import engine as te
from fastqueeze_tpu_torch.ops import host_adapt
from fastqueeze_tpu_torch.ops import kernels as tk

_P = dict(lanes_min=8, lanes_max=64, lane_target_symbols=256)
_CASES = {
    "seq_o6": ("SeqModel", dict(alphabet=4, init=3, inc=1, cap=253,
                                order=6)),
    "fqz_A40_q2": ("QualModel", dict(alphabet=40, init=1, inc=8, cap=8192,
                                     qlevel=2)),
    "fqz_A40_q3": ("QualModel", dict(alphabet=40, init=1, inc=8, cap=8192,
                                     qlevel=3)),
    "chain_k4_hash_pos": ("QualModel", dict(alphabet=8, init=1, inc=16,
                                            cap=8192, k=4, ctx_base=7,
                                            hash_bits=12, pos_bits=3)),
    "order1_byte_A256": ("Order1ByteModel", dict(alphabet=256, init=1,
                                                 inc=16, cap=8192)),
    "flat_nctx4": ("FlatModel", dict(alphabet=256, init=1, inc=16,
                                     cap=8192, n_ctx=4)),
    "order0_A2": ("CtxModel", dict(alphabet=2, init=1, inc=16, cap=8192)),
}


def _case(name, seed):
    """(jax model, port model, per-read counts with zero-length reads,
    symbols, extra_aux or None)."""
    cls, kw = _CASES[name]
    jm, tm = getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 90, 300).astype(np.int64)
    counts[::13] = 0
    n = int(counts.sum())
    if isinstance(tm, tb.QualModel):
        # random-walk ranks: realistic (repetitive) quality contexts
        syms = np.clip(np.cumsum(rng.integers(-2, 3, n)) % 80 - 20, 0,
                       jm.alphabet - 1).astype(np.uint8)
    else:
        syms = rng.integers(0, jm.alphabet, n).astype(np.uint8)
    aux = ({"ctx": rng.integers(0, jm.n_ctx, n).astype(np.uint8)}
           if cls == "FlatModel" else None)
    return jm, tm, counts, syms, aux


@pytest.mark.parametrize("name", sorted(_CASES))
def test_encode_payload_matches_jax(name):
    jm, tm, counts, syms, aux = _case(name, 1)
    want = je.encode_stream(jm, JParams(**_P), syms, counts, extra_aux=aux)
    got = te.encode_stream(tm, CodecParams(**_P), syms, counts, adapt=True,
                           extra_aux=aux, device="cpu")
    assert got == want


@pytest.mark.parametrize("name", sorted(_CASES))
def test_decode_symbols_match_jax(name):
    jm, tm, counts, syms, aux = _case(name, 2)
    payload = je.encode_stream(jm, JParams(**_P), syms, counts,
                               extra_aux=aux)
    want = np.asarray(je.decode_stream(jm, JParams(**_P), payload, counts,
                                       extra_aux=aux))
    got = te.decode_stream(tm, CodecParams(**_P), payload, counts,
                           adapt=True, extra_aux=aux, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(got, syms)


@pytest.mark.parametrize("name,model", [
    ("qual", tb.QualModel(alphabet=48, init=1, inc=8, cap=8192, qlevel=2)),
    ("qual3", tb.QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=3)),
    ("seq", tb.seq_model_from_params(CodecParams(slevel=0)))])
def test_pinned_payload_md5(name, model):
    """tests/test_engine.py's bitstream goldens, reproduced by the port
    (the same seeded draws, in the same order, up to this model)."""
    golden = {"qual": "d37c93864f1ce2ae92d38ee91a4b5ba8",
              "qual3": "7e701d103395308a8439617841b2c39e",
              "seq": "24d73a8a135bc6405c04c56b46c223f8"}
    rng = np.random.default_rng(42)
    p = CodecParams(lanes_min=16, lanes_max=64, lane_target_symbols=512)
    for prev in ("qual", "qual3", "seq"):
        amax = {"qual": 48, "qual3": 40, "seq": 4}[prev]
        lengths = rng.integers(10, 120, 300)
        syms = rng.integers(0, amax, int(lengths.sum())).astype(np.uint8)
        if prev == name:
            break
    payload = te.encode_stream(model, p, syms, lengths, adapt=True,
                               device="cpu")
    assert hashlib.md5(payload).hexdigest() == golden[name]


@pytest.mark.parametrize("name", ["order1_byte_A256", "flat_nctx4",
                                  "order0_A2"])
def test_byte_models_grid_and_walk_match_jax(name):
    """B2': context_grids and the per-wave lane walk of the byte, flat
    and order-0 models agree with the JAX models on every valid slot."""
    jm, tm, counts, syms, aux = _case(name, 3)
    L = 16
    lay = te.make_layout(counts, L)
    g = te.to_grid(lay, syms)
    cg = je._counts_grid(counts, L)
    valid, jaux = je._device_aux(lay.T, jnp.asarray(cg))
    valid = np.array(valid)
    _, taux = tk.device_aux_plain(lay.T, torch.from_numpy(cg))
    if aux is not None:
        cgrid = te.to_grid(lay, aux["ctx"].astype(np.int32))
        jaux = dict(jaux, ctx=jnp.asarray(cgrid))
        taux = dict(taux, ctx=torch.from_numpy(cgrid))
    want = np.asarray(jm.context_grids(jnp.asarray(g), jaux))
    got = tm.context_grids(torch.from_numpy(g), taux).numpy()
    assert np.array_equal(got[valid], want[valid])
    st = tm.lane_init(L, "cpu")
    for t in range(lay.T):
        v = torch.from_numpy(valid[t])
        ta = {k: x[t] for k, x in taux.items()}
        assert np.array_equal(tm.context(st, ta).numpy()[valid[t]],
                              got[t][valid[t]]), t
        new = tm.update(st, torch.from_numpy(g[t]), ta)
        st = {k: torch.where(v, new[k], st[k]) for k in st}
    assert tm.spec()[0] == {"order1_byte_A256": 3, "flat_nctx4": 4,
                            "order0_A2": 2}[name]


@pytest.mark.parametrize("counts", [[0, 0, 0, 0, 0], [], [1]],
                         ids=["zero_length_reads", "no_reads", "one_symbol"])
def test_degenerate_streams_match_jax(counts):
    counts = np.asarray(counts, np.int64)
    syms = np.ones(int(counts.sum()), np.uint8)
    jm = jb.QualModel(alphabet=8, init=1, inc=8, cap=8192, qlevel=2)
    tm = tb.QualModel(alphabet=8, init=1, inc=8, cap=8192, qlevel=2)
    want = je.encode_stream(jm, JParams(), syms, counts)
    assert te.encode_stream(tm, CodecParams(), syms, counts,
                            adapt=True, device="cpu") == want
    back = te.decode_stream(tm, CodecParams(), want, counts, adapt=True,
                            device="cpu")
    assert np.array_equal(back, syms)


def test_overcap_initial_rows_raise():
    """init * A > cap: the kernels (which skip padding lanes) refuse."""
    model = tb.SeqModel(alphabet=4, init=81, inc=1, cap=253, order=6)
    counts = np.array([50, 0, 70], np.int64)
    syms = np.zeros(120, np.uint8)
    with pytest.raises(ValueError, match="cap"):
        te.encode_stream(model, CodecParams(**_P), syms, counts, adapt=True,
                         device="cpu")
    assert not host_adapt.route(CodecParams(), model, "cpu")


def test_jax_overcap_initial_rows_do_not_round_trip():
    """Why the port refuses init * A > cap: the JAX engine's encoder
    halves the rows of padding lanes' contexts from context_grids, its
    decoder from the frozen lane state, so the two walks diverge once a
    padding lane halves an over-cap row that a live lane reads later.
    Seed 4 of this shape decodes wrong symbols (ROADMAP Queue C)."""
    jm = jb.SeqModel(alphabet=4, init=81, inc=1, cap=253, order=6)
    p = JParams(lanes_min=8, lanes_max=8, lane_target_symbols=256)
    rng = np.random.default_rng(4)
    counts = rng.integers(1, 400, 24).astype(np.int64)
    syms = rng.integers(0, 4, int(counts.sum())).astype(np.uint8)
    payload = je.encode_stream(jm, p, syms, counts)
    back = np.asarray(je.decode_stream(jm, p, payload, counts))
    assert not np.array_equal(back, syms)


def test_semi_adaptive_walk_raises():
    """adapt_chunk > 0 dividing T selects B9 (K11/K12) and a counts0 with
    adapt=True adapts from that table: both write the JAX engine's
    payloads and decode them; what still raises is a counts0 row over cap
    on the per-wave walk (K5/K6 skip padding lanes)."""
    jm, tm, counts, syms, _ = _case("seq_o6", 5)
    p, jp = CodecParams(adapt_chunk=128, **_P), JParams(adapt_chunk=128, **_P)
    assert te.make_layout(counts, p.n_lanes(int(counts.sum()))).T % 128 == 0
    payload = te.encode_stream(tm, p, syms, counts, adapt=True, device="cpu")
    assert payload == je.encode_stream(jm, jp, syms, counts)
    assert payload != te.encode_stream(tm, CodecParams(**_P), syms, counts,
                                       adapt=True, device="cpu")
    assert np.array_equal(te.decode_stream(tm, p, payload, counts,
                                           adapt=True, device="cpu"), syms)
    ones = np.ones((tm.n_ctx, 4), np.int32)
    payload = te.encode_stream(tm, CodecParams(**_P), syms, counts,
                               counts0=ones, adapt=True, device="cpu")
    assert payload == je.encode_stream(jm, JParams(**_P), syms, counts,
                                       counts0=jnp.asarray(ones))
    assert np.array_equal(te.decode_stream(tm, CodecParams(**_P), payload,
                                           counts, counts0=ones, adapt=True,
                                           device="cpu"), syms)
    with pytest.raises(ValueError, match="cap"):
        te.encode_stream(tm, CodecParams(**_P), syms, counts,
                         counts0=ones * 100, adapt=True, device="cpu")


def test_native_route_and_payload(monkeypatch):
    """host_adapt.route: native on a CPU device, the card for a CUDA
    device, FASTQUEEZE_ADAPT_EXEC and frozen_exec override; byte models
    and adapt_chunk stay on the engine.  The native payload equals the
    engine's (plain versions)."""
    _, tm, counts, syms, _ = _case("fqz_A40_q2", 6)
    p = CodecParams(**_P)
    if host_adapt.native.get_lib() is None:
        pytest.skip("native library unavailable (make -C native)")
    monkeypatch.delenv("FASTQUEEZE_ADAPT_EXEC", raising=False)
    assert host_adapt.route(p, tm, "cpu")
    assert not host_adapt.route(p, tm, "cuda")
    assert not host_adapt.route(CodecParams(adapt_chunk=64), tm, "cpu")
    assert not host_adapt.route(p, tb.byte_model(p), "cpu")
    assert host_adapt.route(CodecParams(frozen_exec=1), tm, "cuda")
    monkeypatch.setenv("FASTQUEEZE_ADAPT_EXEC", "host")
    assert host_adapt.route(p, tm, "cuda")
    monkeypatch.setenv("FASTQUEEZE_ADAPT_EXEC", "device")
    assert not host_adapt.route(p, tm, "cpu")
    calls = dict(host_adapt.NATIVE_CALLS)
    payload = host_adapt.encode_job(tm, p, syms, counts).finalize()
    assert payload == te.encode_stream(tm, p, syms, counts, adapt=True,
                                       device="cpu")
    back = host_adapt.decode_job(tm, p, payload, counts).finalize()
    assert np.array_equal(back, syms)
    assert host_adapt.NATIVE_CALLS["encode"] == calls["encode"] + 1
    assert host_adapt.NATIVE_CALLS["decode"] == calls["decode"] + 1
