"""Context models for the wave-rANS coder, in PyTorch.

Counterpart of fastqueeze_tpu/models/base.py: the order-0 ``CtxModel``,
``FlatModel`` (contexts supplied per symbol), ``Order1ByteModel``,
``SeqModel`` and ``QualModel``, and the byte/flag constructors.  Each
model is a frozen dataclass of integers: it holds no tensors, so one
instance serves every device and every stream.  Two interfaces, which
must agree bit for bit:

* ``context_grids(syms, aux)`` — vectorized (T, L) contexts, used by the
  encoder's plain path (contexts are pure functions of earlier symbols);
* ``lane_init`` / ``context`` / ``update`` — the per-wave lane walk, used
  by the decoder's plain path (symbols are unknown until decoded).

The CUDA kernels (ops/kernels.py, csrc/lane_walk.cuh) run the lane walk;
``spec()`` hands them the model's integers.

torch has no usable uint32 arithmetic, so everything here computes in
int64 and masks with 0xFFFFFFFF where the reference wraps a u32 (the
Knuth hash of a rank chain, which may wrap before hashing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from fastqueeze_tpu_torch.config import SEQ_CTX_START, CodecParams

_U32 = 0xFFFFFFFF
_KNUTH = 2654435761


def _mul_u32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for 0 <= a < 2^32 without int64 overflow: the
    product is split at k's 16-bit halves."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


@dataclass(frozen=True)
class CtxModel:
    """Order-0 (single context) adaptive model."""

    alphabet: int
    init: int = 1
    inc: int = 16
    cap: int = 8192
    n_ctx: int = 1

    def spec(self) -> Tuple[int, Tuple[int, ...]]:
        """(kind, ints) for the kernels: 0 seq, 1 qual, 2 order-0,
        3 order-1 byte, 4 flat (ctx from a (T, L) grid)."""
        return 2, ()

    def lane_init(self, L: int, device) -> Dict[str, torch.Tensor]:
        return {}

    def context(self, state, aux) -> torch.Tensor:
        return torch.zeros_like(aux["pos"], dtype=torch.int64)

    def update(self, state, sym, aux):
        return state

    def context_grids(self, syms: torch.Tensor, aux) -> torch.Tensor:
        return torch.zeros(syms.shape, dtype=torch.int64, device=syms.device)


@dataclass(frozen=True)
class FlatModel(CtxModel):
    """Context supplied per symbol in ``aux["ctx"]`` (length bytes,
    precomputed stream metadata)."""

    def spec(self) -> Tuple[int, Tuple[int, ...]]:
        return 4, ()

    def context(self, state, aux) -> torch.Tensor:
        return aux["ctx"].long()

    def context_grids(self, syms: torch.Tensor, aux) -> torch.Tensor:
        return aux["ctx"].long()


@dataclass(frozen=True)
class Order1ByteModel(CtxModel):
    """Context = previous symbol; 0 at each read start."""

    def __post_init__(self):
        object.__setattr__(self, "n_ctx", self.alphabet)

    def spec(self) -> Tuple[int, Tuple[int, ...]]:
        return 3, ()

    def lane_init(self, L: int, device) -> Dict[str, torch.Tensor]:
        return {"prev": torch.zeros((L,), dtype=torch.int64, device=device)}

    def context(self, state, aux) -> torch.Tensor:
        return torch.where(aux["start"], 0, state["prev"])

    def update(self, state, sym, aux):
        return {"prev": sym.long()}

    def context_grids(self, syms: torch.Tensor, aux) -> torch.Tensor:
        prev = torch.roll(syms.long(), 1, dims=0)
        prev[0] = 0
        return torch.where(aux["start"], 0, prev)


@dataclass(frozen=True)
class SeqModel(CtxModel):
    """2-bit base model: context = previous ``order`` bases, reset to
    ``0x007616C7 & mask`` at every read start."""

    order: int = 10

    def __post_init__(self):
        object.__setattr__(self, "n_ctx", 1 << (2 * self.order))

    @property
    def mask(self) -> int:
        return (1 << (2 * self.order)) - 1

    def spec(self) -> Tuple[int, Tuple[int, ...]]:
        """(kind, ints) for the kernels and the native walker."""
        return 0, (self.mask, SEQ_CTX_START & self.mask)

    def lane_init(self, L: int, device) -> Dict[str, torch.Tensor]:
        return {"h": torch.full((L,), SEQ_CTX_START & self.mask,
                                dtype=torch.int64, device=device)}

    def _eff(self, state, aux):
        return torch.where(aux["start"], SEQ_CTX_START & self.mask,
                           state["h"])

    def context(self, state, aux) -> torch.Tensor:
        return self._eff(state, aux) & self.mask

    def update(self, state, sym, aux):
        h = self._eff(state, aux)
        return {"h": ((h << 2) | sym.long()) & self.mask}

    def context_grids(self, syms: torch.Tensor, aux) -> torch.Tensor:
        """ctx at in-read position p = ((MAGIC << 2p) | pack(last
        min(p, order) bases)) & mask, from `order` shifted grids."""
        pos = aux["pos"].long()
        s = syms.long()
        acc = torch.zeros_like(s)
        for j in range(1, self.order + 1):
            prev_j = torch.roll(s, j, dims=0)
            acc = acc | (torch.where(pos >= j, prev_j, 0) << (2 * (j - 1)))
        magic = SEQ_CTX_START & self.mask
        shift = torch.clamp(pos, max=self.order) * 2
        magic_part = torch.where(pos < self.order, magic << shift, 0)
        return (acc | magic_part) & self.mask


@dataclass(frozen=True)
class QualModel(CtxModel):
    """fqzcomp quality context (k = 0) or a rank chain over the last k
    ranks with optional Knuth hash, drop bits and pos bits (k >= 2); the
    formulas are those of fastqueeze_tpu/models/base.py QualModel."""

    qlevel: int = 2
    drop_init: int = 5
    k: int = 0
    ctx_base: int = 0
    drop_bits: int = 0
    pos_bits: int = 0
    hash_bits: int = 0

    def __post_init__(self):
        if self.k >= 2:
            rows = ((1 << self.hash_bits) if self.hash_bits
                    else self.ctx_base ** self.k)
            n = rows << (self.drop_bits + self.pos_bits)
        else:
            n = (1 << 20) if self.qlevel >= 3 else (1 << 16)
        object.__setattr__(self, "n_ctx", n)

    def spec(self) -> Tuple[int, Tuple[int, ...]]:
        return 1, (self.k, self.ctx_base, self.hash_bits, self.drop_bits,
                   self.pos_bits, self.qlevel, self.drop_init)

    def lane_init(self, L: int, device) -> Dict[str, torch.Tensor]:
        z = torch.zeros((L,), dtype=torch.int64, device=device)
        st = {"q1": z, "q2": z, "drops": z + self.drop_init}
        for j in range(3, self.k + 1):
            st[f"q{j}"] = z
        return st

    def _eff(self, state, aux):
        start = aux["start"]
        q1 = torch.where(start, 0, state["q1"])
        q2 = torch.where(start, 0, state["q2"])
        drops = torch.where(start, self.drop_init, state["drops"])
        qk = [torch.where(start, 0, state[f"q{j}"])
              for j in range(3, self.k + 1)]
        return q1, q2, drops, qk

    def context(self, state, aux) -> torch.Tensor:
        q1, q2, drops, qk = self._eff(state, aux)
        return self._ctx_of([q1, q2] + qk, drops, aux["pos"].long())

    def update(self, state, sym, aux):
        q1, q2, drops, qk = self._eff(state, aux)
        sym = sym.long()
        st = {"q1": sym, "q2": q1,
              "drops": drops + torch.clamp(q1 - sym, min=0)}
        prev = q2
        for j in range(3, self.k + 1):
            st[f"q{j}"] = prev
            prev = qk[j - 3]
        return st

    def _ctx_of(self, qs: List[torch.Tensor], drops, pos) -> torch.Tensor:
        if self.k >= 2:
            b = self.ctx_base
            ctx = torch.clamp(qs[0], max=b - 1)
            for qj in qs[1:self.k]:
                # the chain lives on the u32 ring: a deep chain wraps
                # before the hash, exactly as the reference's int32/u32
                ctx = (ctx * b + torch.clamp(qj, max=b - 1)) & _U32
            if self.hash_bits:
                ctx = _mul_u32(ctx, _KNUTH) & ((1 << self.hash_bits) - 1)
            if self.drop_bits:
                ctx = (ctx << self.drop_bits) | torch.clamp(
                    drops >> 3, max=(1 << self.drop_bits) - 1)
            if self.pos_bits:
                ctx = (ctx << self.pos_bits) | torch.clamp(
                    pos >> 4, max=(1 << self.pos_bits) - 1)
            return ctx
        q1, q2 = qs[0], qs[1]
        ctx = ((torch.maximum(q1, q2) << 6) + q1) & 0xFFF
        if self.qlevel >= 2:
            ctx = ctx + torch.where(q1 == q2, 0x1000, 0)
            ctx = ctx + ((torch.clamp(drops, max=56) & ~7) << 10)
        if self.qlevel >= 3:
            ctx = ctx + (torch.clamp(pos >> 3, max=15) << 16)
        return ctx

    def context_grids(self, syms: torch.Tensor, aux) -> torch.Tensor:
        """q1..qk by in-lane shifts; drops by a per-read segmented
        cumulative sum down the wave axis."""
        pos = aux["pos"].long()
        q = syms.long()
        qs = [torch.where(pos >= j, torch.roll(q, j, dims=0), 0)
              for j in range(1, max(self.k, 2) + 1)]
        q1 = qs[0]
        d = torch.where(pos >= 1, torch.clamp(q1 - q, min=0), 0)
        cs = torch.cumsum(d, dim=0)
        csx = cs - d
        t_idx = torch.arange(syms.shape[0], device=syms.device)[:, None]
        base = torch.gather(csx, 0, t_idx - pos)
        drops = torch.where(pos >= 1,
                            self.drop_init + torch.roll(cs, 1, dims=0) - base,
                            self.drop_init)
        return self._ctx_of(qs, drops, pos)


def seq_model_from_params(p: CodecParams) -> SeqModel:
    return SeqModel(alphabet=4, init=p.seq_init, inc=p.seq_inc,
                    cap=p.seq_cap, order=p.seq_order())


def qual_model_for(p: CodecParams, alphabet: int) -> QualModel:
    """QualModel with the archive's context scheme at a given (per-block)
    alphabet — the single construction point for encode and decode."""
    return QualModel(alphabet=alphabet, init=p.qual_init,
                     inc=p.qual_inc, cap=p.qual_cap, qlevel=p.qlevel,
                     drop_init=p.q_drop_init, k=p.qctx_k,
                     ctx_base=p.qctx_base, drop_bits=p.qctx_drop_bits,
                     pos_bits=p.qctx_pos_bits, hash_bits=p.qctx_hash_bits)


def byte_model(p: CodecParams, order1: bool = True) -> CtxModel:
    cls = Order1ByteModel if order1 else CtxModel
    return cls(alphabet=256, init=p.byte_init, inc=p.byte_inc,
               cap=p.byte_cap, n_ctx=256 if order1 else 1)


def flag_model(p: CodecParams, n_ctx: int = 1) -> CtxModel:
    if n_ctx == 1:
        return CtxModel(alphabet=2, init=p.byte_init, inc=p.byte_inc,
                        cap=p.byte_cap)
    return FlatModel(alphabet=2, init=p.byte_init, inc=p.byte_inc,
                     cap=p.byte_cap, n_ctx=n_ctx)
