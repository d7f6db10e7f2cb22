"""K18's two routes, plain versions held to fastqueeze_tpu's sharded decode.

The JAX side is fastqueeze_tpu.parallel.mesh.decode_blocks_frozen_sharded
on its 8 virtual CPU devices (tests/conftest.py); the port's is
parallel/mesh.decode_blocks_frozen_sharded on a mesh of CPU shards, where
K18 takes its plain version.  The cases are the ones the redesigned
kernel branches on: D = 2, 4 and 8 row shards on the seq and qual model
kinds, lanes whose contexts fall on both sides of every shard boundary
(asserted), lanes of length 0 and zero-length reads between reads, and
the several-card route's layout, one (1, 3, L) partial a card summed
over two groups of shards (a CPU mirror of ShardDecode.step's schedule).
Every output is an integer, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqueeze_tpu.config import RANS_L
from fastqueeze_tpu.models.base import QualModel as JQual
from fastqueeze_tpu.models.base import SeqModel as JSeq
from fastqueeze_tpu.parallel import mesh as jm
from fastqueeze_tpu_torch.models.base import QualModel, SeqModel
from fastqueeze_tpu_torch.ops import kernels
from fastqueeze_tpu_torch.parallel import mesh as tm

CPU = torch.device("cpu")
B, T, L = 4, 48, 24
_MODELS = {"seq": (SeqModel(alphabet=4, order=3), JSeq(alphabet=4, order=3)),
           "qual": (QualModel(alphabet=40, init=1, inc=8, cap=8192,
                              qlevel=2),
                    JQual(alphabet=40, init=1, inc=8, cap=8192, qlevel=2))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(model, seed: int):
    """Raw counts skewed toward a few symbols, random states and words,
    and (B, J, L) read lengths: reads of 0-16 symbols back to back, two
    lanes with no symbol at all; the JAX side's (valid, pos) grids from
    the same read lengths."""
    rng = np.random.default_rng(seed)
    counts0 = (rng.integers(1, 50, (model.n_ctx, model.alphabet)) ** 2
               ).astype(np.int32)
    states = rng.integers(RANS_L, 1 << 31, (B, L)).astype(np.uint32)
    words = rng.integers(0, 1 << 16, (B, 2048)).astype(np.uint16)
    J = 6
    cgrid = rng.integers(0, 17, (B, J, L)).astype(np.int32)
    cgrid[:, :, [3, 17]] = 0
    for b in range(B):       # no lane runs past T waves
        over = cgrid[b].sum(0) > T
        cgrid[b][:, over] = 0
    valid, pos = [], []
    for b in range(B):
        v, aux = kernels.device_aux_plain(T, torch.from_numpy(cgrid[b]))
        valid.append(v.numpy())
        pos.append(aux["pos"].numpy().astype(np.int32))
    return counts0, states, words, cgrid, np.stack(valid), np.stack(pos)


def _jax_decode(jmod, D, counts0, states, words, valid, pos):
    """The JAX sharded decode; its symbols at padding slots (whatever the
    owner's search gives) as 0, the port's convention."""
    js, jx = jm.decode_blocks_frozen_sharded(
        jm.make_mesh(8, ctx_shards=D), jmod, jnp.asarray(counts0),
        jnp.asarray(states), jnp.asarray(words), jnp.asarray(valid),
        jnp.asarray(pos))
    return np.where(valid, np.asarray(js), 0), np.asarray(jx)


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("kind", ["seq", "qual"])
def test_ctx_shard_plain_equals_jax(kind, D, monkeypatch):
    """B18 through the port's mesh (K18's plain version, D CPU shards)
    == the JAX sharded decoder: symbols and final states; the symbols
    also == the port's unsharded frozen_decode_plain.  Lanes meet
    contexts on both sides of every shard boundary (seq: all 64 order-3
    contexts) and lanes of length 0 stay at their initial state."""
    tmod, jmod = _MODELS[kind]
    counts0, states, words, cgrid, valid, pos = _inputs(tmod, 31 + D)
    seen = []
    real = kernels._shard_partial

    def spy(Fs, d0, n, ctx, low, vld, A):
        seen.append(ctx[vld])
        return real(Fs, d0, n, ctx, low, vld, A)

    monkeypatch.setattr(kernels, "_shard_partial", spy)
    ts, tx = tm.decode_blocks_frozen_sharded(
        tm.Mesh([CPU] * D, ctx_shards=D), tmod, counts0,
        states.view(np.int32), words.view(np.int16), cgrid, T)
    js, jx = _jax_decode(jmod, D, counts0, states, words, valid, pos)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tx.numpy().view(np.uint32), jx)
    # the two empty lanes keep their initial states
    np.testing.assert_array_equal(jx[:, [3, 17]], states[:, [3, 17]])
    n = tmod.n_ctx // D
    ctx = set(torch.cat(seen).tolist())
    owners = {c // n for c in ctx}
    if kind == "seq":
        for d in range(1, D):
            assert {d * n - 1, d * n} <= ctx, f"boundary {d * n} not met"
    else:
        assert len(owners) >= 2
    cum = kernels.quant_pack_plain(torch.from_numpy(counts0))[0]
    for b in range(B):
        full = kernels.frozen_decode_plain(
            torch.from_numpy(states[b].view(np.int32)),
            torch.from_numpy(words[b].view(np.int16)),
            torch.from_numpy(cgrid[b]), T, cum, tmod)
        np.testing.assert_array_equal(ts[b].numpy(), full.numpy())


def _steps_mirror(st, wd, cg, cums, model, groups):
    """The several-card route's layout on the CPU (ShardDecode.step's
    schedule): every group of shards keeps its own lane state and writes
    one (1, 3, L) partial a wave, summing its shards' (_shard_partial);
    mesh.psum sums the groups' partials, and each group runs the rANS
    step (_shard_rans) and the model update on the sum.  Returns the
    first group's (symbols, final states), each wave's partials."""
    A, n = model.alphabet, cums[0].shape[0]
    valid, aux = kernels.device_aux_plain(T, cg)
    w16 = kernels._u16(wd)
    lanes = [[model.lane_init(L, CPU), kernels._u32(st), 0] for _ in groups]
    out = torch.zeros((T, L), dtype=torch.uint8)
    seen = []
    for t in range(T):
        vld = valid[t]
        aux_t = {"start": aux["start"][t], "pos": aux["pos"][t]}
        parts = [torch.stack([kernels._to_i32(p) for p in
                              kernels._shard_partial(
                                  [kernels._u16(cums[c]).reshape(-1)
                                   for c in g], g[0], n,
                                  model.context(ls, aux_t),
                                  x & (kernels.RANS_M - 1), vld, A)])[None]
                 for g, (ls, x, _) in zip(groups, lanes)]
        seen.append(parts)
        tot = kernels._u32(tm.psum(parts)[0][0])
        sym, start, f = tot[0], tot[1], tot[2]
        for lane in lanes:
            lane[1], lane[2] = kernels._shard_rans(lane[1], sym, start, f,
                                                   vld, w16, lane[2])
            new = model.update(lane[0], sym, aux_t)
            lane[0] = {k: torch.where(vld, new[k], lane[0][k])
                       for k in lane[0]}
        out[t] = torch.where(vld, sym, 0).to(torch.uint8)
    return out, kernels._to_i32(lanes[0][1]), seen


@pytest.mark.parametrize("kind", ["seq", "qual"])
def test_ctx_shard_steps_one_partial_a_card(kind):
    """The several-card route's layout, mirrored on the CPU: the D = 4
    shards in two groups, one (1, 3, L) partial a group and wave, exactly
    one group owning each valid lane's context, the partials summed by
    mesh.psum == the one-call route == the JAX sharded decoder."""
    tmod, jmod = _MODELS[kind]
    counts0, states, words, cgrid, valid, pos = _inputs(tmod, 5)
    cum = kernels.quant_pack_plain(torch.from_numpy(counts0))[0]
    n = tmod.n_ctx // 4
    cums = [cum[i * n:(i + 1) * n] for i in range(4)]
    js, jx = _jax_decode(jmod, 4, counts0, states, words, valid, pos)
    for b in range(B):
        st = torch.from_numpy(states[b].view(np.int32))
        wd = torch.from_numpy(words[b].view(np.int16))
        cg = torch.from_numpy(cgrid[b])
        out, x, seen = _steps_mirror(st, wd, cg, cums, tmod,
                                     [[0, 1], [2, 3]])
        for parts in seen:
            owned = [(p[0, 2] != 0) for p in parts]
            assert not bool((owned[0] & owned[1]).any())
        one = kernels.ctx_shard_decode(st, wd, cg, T, cums, tmod)
        assert torch.equal(out, one[0]) and torch.equal(x, one[1])
        np.testing.assert_array_equal(out.numpy(), js[b])
        np.testing.assert_array_equal(x.numpy().view(np.uint32), jx[b])
