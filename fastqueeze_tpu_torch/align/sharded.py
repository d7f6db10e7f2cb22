"""Sharded-index aligner for references past the single-device limit.

Copied from fastqueeze_tpu/align/sharded.py.  ``Aligner`` (align/hash.py)
refuses indexes with >= 2^31 positions (human-scale whole genomes: GRCh38
is ~3.1 Gbp) because its kernels and host tiers carry int32 coordinates.
This class serves that regime: the counted-CSR index is split into
equal-key-count range shards over the mesh's devices
(parallel/mesh.shard_ref_index, u32 coordinates, up to 4 Gbp) and every
batch runs the one-pass multi-seed gapless alignment with pmin/pmax
lookup collectives (parallel/mesh.align_blocks_index_sharded, K19).

Its envelope beside Aligner: gapless only (no indel tier: such reads stay
entropy-coded) and no PE window rescue; the multi-seed candidate
diversity (rescue_seeds, seed_excl_bp) runs in the single pass.
``pipeline/aligned.prepare_ref`` picks this class when the index reaches
SHARD_MIN_POSITIONS.
"""

from __future__ import annotations

import numpy as np

from fastqueeze_tpu_torch.align.hash import AlignResult, _gridify
from fastqueeze_tpu_torch.align.index import RefIndex
from fastqueeze_tpu_torch.config import CodecParams

# Indexes at or past this many positions (or reference bases) exceed the
# single-device int32 coordinate space and route here.  Tests monkeypatch
# it to run the path at toy scale.
SHARD_MIN_POSITIONS = 1 << 31


def _intra(lengths: np.ndarray) -> np.ndarray:
    """In-read offsets 0..len-1 of every read, concatenated."""
    n = int(lengths.sum())
    return (np.arange(n, dtype=np.int64)
            - np.repeat(np.cumsum(lengths) - lengths, lengths))


class ShardedAligner:
    BATCH = 4096

    def __init__(self, idx: RefIndex, params: CodecParams, devices=None,
                 kind: str = "cuda"):
        from fastqueeze_tpu_torch.parallel.mesh import (
            Mesh, shard_ref_index, visible_devices)
        devs = devices or visible_devices(kind)
        n = (params.mesh_n if params.mesh_n and params.mesh_n > 0
             else len(devs))
        n = min(n, len(devs))
        if n < 2:
            raise ValueError(
                f"reference has {idx.n_positions} indexed positions — past "
                "the single-device int32 limit; the sharded-index path "
                "needs a multi-device mesh (--mesh N, N >= 2)")
        self.params = params
        self.k = idx.k
        self.ref_len = idx.ref_len
        self.n_shards = n
        self.mesh = Mesh(devs[:n], ctx_shards=n)
        self.sh = shard_ref_index(idx, n)

    def _lp_bucket(self, max_len: int) -> int:
        lp = 32
        while lp < max_len:
            lp *= 2
        return lp

    def align(self, codes_flat: np.ndarray, dege_flat: np.ndarray,
              lengths: np.ndarray, device=None, allow_indel: bool = True,
              max_indel=None) -> AlignResult:
        """Aligner.align-compatible: the reads run on the mesh's devices
        (``device`` unused), the indel arguments are accepted and ignored
        (gapless envelope: the gap fields come back None)."""
        p = self.params
        R = len(lengths)
        if R == 0 or self.ref_len < self.k:
            lp = 32
            return AlignResult(np.zeros(R, bool), np.zeros(R, np.int64),
                               np.zeros(R, bool), np.zeros((R, lp), bool))
        cap = p.align_max_len
        max_len = int(lengths.max())
        if max_len > cap:
            # long reads skip the per-read grid (their chunks arrive here
            # separately via the long-read tier), as Aligner's shell does
            sel = np.flatnonzero(lengths <= cap)
            lp = self._lp_bucket(int(lengths[sel].max()) if len(sel)
                                 else 32)
            res = AlignResult(np.zeros(R, bool), np.zeros(R, np.int64),
                              np.zeros(R, bool), np.zeros((R, lp), bool))
            if len(sel):
                off = np.cumsum(lengths) - lengths
                idx2 = (np.repeat(off[sel], lengths[sel])
                        + _intra(lengths[sel]))
                sub = self.align(codes_flat[idx2], dege_flat[idx2],
                                 lengths[sel])
                res.mapped[sel] = sub.mapped
                res.pos[sel] = sub.pos
                res.is_rev[sel] = sub.is_rev
                res.mis_mask[sel] = sub.mis_mask
            return res
        from fastqueeze_tpu_torch.parallel.mesh import (
            align_blocks_index_sharded)
        lp = self._lp_bucket(max_len)
        codes_g, dege_g = _gridify(codes_flat, dege_flat, lengths, lp)
        mapped = np.zeros(R, bool)
        pos = np.zeros(R, np.int64)
        is_rev = np.zeros(R, bool)
        mis_mask = np.zeros((R, lp), bool)
        for s in range(0, R, self.BATCH):
            sl = slice(s, min(s + self.BATCH, R))
            m, p_, r, mm = align_blocks_index_sharded(
                self.mesh, p, self.sh, codes_g[sl], dege_g[sl], lengths[sl],
                n_seeds=p.rescue_seeds, excl_bp=p.seed_excl_bp,
                n_cand=p.seed_max_occ)
            mapped[sl] = m
            pos[sl] = p_.astype(np.int64)     # u32 coordinates, widened
            is_rev[sl] = r
            mis_mask[sl] = mm
        return AlignResult(mapped, pos, is_rev, mis_mask)

    def rescue_mates(self, codes_flat, dege_flat, lengths, res, max_insr,
                     device=None):
        """PE insert-window rescue is not in the sharded envelope (the
        window verify carries int32 coordinates); pairs keep their
        independent mappings."""
        return res
