"""Lane layout: ragged per-read symbol sequences <-> fixed (T, L) wave grids.

The wave engine codes ``L`` interleaved rANS lanes in lockstep; read ``r`` is
assigned to lane ``r % L`` (round-robin keeps lanes balanced for i.i.d. read
lengths), and a lane's symbol sequence is the concatenation of its reads'
symbols.  ``T`` = longest lane.  The layout is a pure function of the
per-read symbol counts, so the decoder (which decodes lengths first)
reconstructs the identical grid coordinates.

This replaces the reference's serial per-read loops (compressSeq @0x4249c7
iterating encode_seq read-by-read, SURVEY.md §2.1) with a batched layout.

Per-symbol (N,)-sized coordinate arrays are built lazily: the hot grid
scatter/gather runs per read in native C++ (native/trainhist.cpp
fq_grid_scatter/gather) from the tiny (R,)-sized arrays, so the common path
never materializes N-sized indices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class LaneLayout:
    L: int                      # number of lanes
    T: int                      # waves (max lane length), padded
    counts: np.ndarray          # (R,) per-read symbol counts
    lane_len: np.ndarray        # (L,) symbols per lane
    read_start_t: np.ndarray    # (R,) wave index of each read's first symbol
    read_lane: np.ndarray       # (R,) lane of each read
    const_len: int = 0          # > 0: every read has this length (fast path)
    _sym_t: Optional[np.ndarray] = None      # (N,) wave per symbol (lazy)
    _sym_lane: Optional[np.ndarray] = None   # (N,) lane per symbol (lazy)

    @property
    def n_symbols(self) -> int:
        return int(self.counts.sum())

    def sym_coords(self) -> Tuple[np.ndarray, np.ndarray]:
        """(N,) per-symbol (wave, lane) coordinates in read-major order,
        built on first use."""
        if self._sym_t is None:
            counts = self.counts
            R = len(counts)
            N = int(counts.sum())
            rep_read = np.repeat(np.arange(R), counts)
            intra = np.arange(N, dtype=np.int64) - np.repeat(
                np.cumsum(counts) - counts, counts)
            self._sym_t = self.read_start_t[rep_read] + intra
            self._sym_lane = self.read_lane[rep_read]
        return self._sym_t, self._sym_lane


def _bucket_T(n: int, t_pad: int) -> int:
    """Round the wave count up to a bucketed size (multiples of t_pad up to
    1024, then {1, 1.5} x powers of two).  The reference bucketed T so its
    jitted kernels compile once per bucket; the bucketed T is written in
    every payload header and checked at decode, so the port keeps it
    exactly (the kernels run the padding waves as idle slots)."""
    n = max(n, t_pad)
    if n <= 1024:
        return ((n + t_pad - 1) // t_pad) * t_pad
    p = 1024
    while True:
        for cand in (p, p + p // 2):
            if n <= cand:
                return cand
        p <<= 1


def make_layout(counts: np.ndarray, L: int, t_pad: int = 128) -> LaneLayout:
    """Build the grid coordinate map for per-read symbol counts.

    Constant-length reads (the dominant case) take a coordinate-free fast
    path: the grid is a pure reshape/transpose of the flat symbol array.
    Ragged reads build only (R,)-sized arrays here; (N,)-sized coordinates
    are lazy (sym_coords)."""
    counts = np.asarray(counts, dtype=np.int64)
    R = len(counts)
    if R and counts.min() == counts.max() and counts[0] > 0:
        C = int(counts[0])
        J = (R + L - 1) // L
        T = _bucket_T(J * C, t_pad)
        lane_cnt = np.full(L, R // L, np.int64)
        lane_cnt[:R - (R // L) * L] += 1
        return LaneLayout(L=L, T=T, counts=counts, lane_len=lane_cnt * C,
                          read_start_t=None, read_lane=None, const_len=C)
    read_lane = (np.arange(R, dtype=np.int64) % L) if R else np.zeros(0, np.int64)

    # Start offset of each read within its lane.  Round-robin assignment
    # means the reads of lane l are r = l, l+L, l+2L, ...: pad counts to a
    # (J, L) grid and exclusive-cumsum down each column.
    J = (R + L - 1) // L if R else 0
    cpad = np.zeros(J * L, np.int64)
    cpad[:R] = counts
    cgrid = cpad.reshape(J, L)
    starts = np.cumsum(cgrid, axis=0) - cgrid              # (J, L)
    read_start_t = starts.reshape(-1)[:R]
    lane_len = cgrid.sum(axis=0)

    T_real = int(lane_len.max()) if R else 0
    T = _bucket_T(T_real, t_pad)
    return LaneLayout(L=L, T=T, counts=counts, lane_len=lane_len,
                      read_start_t=read_start_t, read_lane=read_lane)


def to_grid(layout: LaneLayout, flat: np.ndarray,
            fill: int = 0, dtype=None) -> np.ndarray:
    """Scatter read-major flat symbols into the (T, L) grid."""
    dtype = dtype or flat.dtype
    grid = np.full((layout.T, layout.L), fill, dtype=dtype)
    if layout.const_len:
        C, L, R = layout.const_len, layout.L, len(layout.counts)
        J = (R + L - 1) // L
        pad = np.zeros(J * L * C, dtype=flat.dtype)
        pad[:R * C] = flat
        # read r = j*L + l occupies rows j*C..(j+1)*C-1 of lane l
        grid[:J * C] = pad.reshape(J, L, C).transpose(0, 2, 1).reshape(
            J * C, L)
        return grid
    from fastqueeze_tpu_torch.io import native
    if (grid.dtype.itemsize in (1, 2)
            and flat.dtype.itemsize == grid.dtype.itemsize
            and native.grid_scatter(flat, layout.counts, layout.read_start_t,
                                    layout.read_lane, grid)):
        return grid
    sym_t, sym_lane = layout.sym_coords()
    grid[sym_t, sym_lane] = flat
    return grid


def from_grid(layout: LaneLayout, grid: np.ndarray) -> np.ndarray:
    """Gather the (T, L) grid back to read-major flat symbols."""
    grid = np.asarray(grid)
    if layout.const_len:
        C, L, R = layout.const_len, layout.L, len(layout.counts)
        J = (R + L - 1) // L
        flat = grid[:J * C].reshape(J, C, L).transpose(0, 2, 1).reshape(-1)
        return flat[:R * C]
    from fastqueeze_tpu_torch.io import native
    if grid.dtype.itemsize in (1, 2) and grid.flags.c_contiguous:
        flat = np.empty(layout.n_symbols, grid.dtype)
        if native.grid_gather(grid, layout.counts, layout.read_start_t,
                              layout.read_lane, flat):
            return flat
    sym_t, sym_lane = layout.sym_coords()
    return grid[sym_t, sym_lane]
