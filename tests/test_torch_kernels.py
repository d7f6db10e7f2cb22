"""Plain PyTorch versions of the four CUDA kernels against fastqueeze_tpu.

On the CPU every kernel wrapper takes its plain version; these tests hold
those versions to the JAX engine on the same seeded inputs: K1 against
_quant_full, K2+K3 (through the port's engine) against the payload bytes
of encode_stream(adapt=False), K4 against decode_stream(adapt=False).
The kernels themselves are held to the plain versions on the card by
tests/test_torch_gpu.py.
"""

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
from fastqueeze_tpu_torch.ops import kernels as tk

_P = dict(lanes_min=8, lanes_max=64, lane_target_symbols=256)
_CASES = {
    "seq_o6": ("SeqModel", dict(alphabet=4, init=3, inc=1, cap=253,
                                order=6)),
    "fqz_A40": ("QualModel", dict(alphabet=40, qlevel=2)),
    "chain_k4_hash_pos": ("QualModel", dict(alphabet=8, k=4, ctx_base=7,
                                            hash_bits=12, pos_bits=3)),
    "chain_k3_drop": ("QualModel", dict(alphabet=16, k=3, ctx_base=10,
                                        drop_bits=2)),
}


def _case(name, seed):
    cls, kw = _CASES[name]
    jm, tm = getattr(jb, cls)(**kw), getattr(tb, cls)(**kw)
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 90, 400).astype(np.int64)
    counts[::13] = 0                      # zero-length reads
    syms = rng.integers(0, jm.alphabet, int(counts.sum())).astype(np.uint8)
    top = 254 if jm.alphabet == 4 else 300
    table = rng.integers(1, top, (jm.n_ctx, jm.alphabet)).astype(np.int32)
    return jm, tm, counts, syms, table


def test_quant_pack_plain_matches_quant_full():
    rng = np.random.default_rng(0)
    for A, hi in ((4, 254), (48, 341), (8, 1 << 11)):
        counts = rng.integers(1, hi, (512, A)).astype(np.int32)
        want = np.asarray(je._quant_full(jnp.asarray(counts)))
        cum, packed = tk.quant_pack(torch.from_numpy(counts))
        F = cum.numpy().view(np.uint16).astype(np.int64)
        assert np.array_equal(F, want)
        P = packed.numpy().view(np.uint32).reshape(512, A).astype(np.int64)
        assert np.array_equal(P, want[:, :-1] | (want[:, 1:] << 16))


@pytest.mark.parametrize("name", sorted(_CASES))
def test_encode_payload_matches_jax(name):
    jm, tm, counts, syms, table = _case(name, 1)
    want = je.encode_stream(jm, JParams(**_P), syms, counts,
                            counts0=jnp.asarray(table), adapt=False)
    got = te.encode_stream(tm, CodecParams(**_P), syms, counts,
                           counts0=table)
    assert got == want


@pytest.mark.parametrize("name", sorted(_CASES))
def test_decode_symbols_match_jax(name):
    jm, tm, counts, syms, table = _case(name, 2)
    payload = je.encode_stream(jm, JParams(**_P), syms, counts,
                               counts0=jnp.asarray(table), adapt=False)
    want = je.decode_stream(jm, JParams(**_P), payload, counts,
                            counts0=jnp.asarray(table), adapt=False)
    got = te.decode_stream(tm, CodecParams(**_P), payload, counts,
                           counts0=te.frozen_table(table, "cpu"))
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, syms)


def test_compact_words_plain_matches_jax():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 16, (96, 32)).astype(np.uint16)
    emit = rng.random((96, 32)) < 0.4
    want, n = je._compact_words(jnp.asarray(words), jnp.asarray(emit))
    out, count = tk.compact_words(torch.from_numpy(words.view(np.int16)),
                                  torch.from_numpy(emit.astype(np.uint8)))
    k = int(n)
    assert int(count.item()) == k
    assert np.array_equal(out[:k].numpy().view(np.uint16),
                          np.asarray(want)[:k])


def test_pass2_plain_matches_jax():
    """Reverse rANS, including frequency-0 slots (f_safe) and padding."""
    rng = np.random.default_rng(4)
    T, L = 64, 16
    start = rng.integers(0, 1 << 13, (T, L))
    freq = rng.integers(0, 1 << 13, (T, L))
    valid = rng.random((T, L)) < 0.9
    w, e, x = je._pass2(jnp.asarray(start, jnp.uint16),
                        jnp.asarray(freq, jnp.uint16), jnp.asarray(valid))
    tw, te_, tx = tk.pass2_plain(torch.from_numpy(start),
                                 torch.from_numpy(freq),
                                 torch.from_numpy(valid))
    e = np.asarray(e)
    assert np.array_equal(te_.numpy().astype(bool), e)
    assert np.array_equal(tw.numpy().view(np.uint16)[e], np.asarray(w)[e])
    assert np.array_equal(tx.numpy().view(np.uint32), np.asarray(x))


def test_wrappers_take_plain_path_on_cpu_only():
    tk.reset_launch_counts()
    tk.quant_pack(torch.ones((4, 4), dtype=torch.int32))
    assert sum(tk.LAUNCHES.values()) == 0      # plain versions never count
    with pytest.raises(ValueError):            # neither CPU nor CUDA
        tk.quant_pack(torch.ones((4, 4), dtype=torch.int32, device="meta"))


def test_adaptive_not_ported():
    _, tm, counts, syms, table = _case("seq_o6", 5)
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        te.encode_stream(tm, CodecParams(**_P), syms, counts, table,
                         adapt=True)


def test_truncated_payload_raises_value_error():
    _, tm, counts, syms, table = _case("seq_o6", 6)
    p = CodecParams(**_P)
    payload = te.encode_stream(tm, p, syms, counts, counts0=table)
    with pytest.raises(ValueError):
        te.decode_stream(tm, p, payload[:len(payload) // 2], counts,
                         counts0=table)
    with pytest.raises(ValueError):            # header symbol count
        te.decode_stream(tm, p, payload, counts[:-3], counts0=table)
