"""Multi-device execution over a mesh of torch devices.

Counterpart of fastqueeze_tpu/parallel/mesh.py.  One process drives every
device, as JAX's single controller does (no torch.distributed):

* **block axis (data parallel)**: whole blocks round-robin over the
  devices (:func:`block_devices`, :func:`device_cycled`); payloads are
  device-count invariant, so --mesh N archives equal -t 1 ones;
* **ctx axis**: a frozen table too big to copy to every device is split
  by context rows (:func:`decode_blocks_frozen_sharded`, K18), and a
  reference index too big for one device by key range
  (:func:`shard_ref_index`, :func:`align_blocks_index_sharded`, K19).

A :class:`Mesh` is a (block, ctx) grid of torch devices.  A device may
appear more than once: its shards then share it, each on a CUDA stream of
its own (the tests and the smoke build such meshes through the one seam
:func:`visible_devices`).  The collectives (:func:`psum`, :func:`pmin`,
:func:`pmax`) take one tensor a shard of one mesh axis: with N cards
they gather to the axis's first device, reduce there and copy the result
back (device-to-device copies, over NVLink where the cards have it);
shards that share a card reduce on that card.  The mesh trainer's reduce
over 'block' is the row pass's own (:func:`train_counts_sharded`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fastqueeze_tpu_torch.ops import kernels

def visible_devices(kind: str = "cuda") -> List[torch.device]:
    """The devices a mesh may use: every CUDA card, or the one CPU."""
    if torch.device(kind).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _stream(dev: torch.device):
    return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None


@contextlib.contextmanager
def on_shard(dev: torch.device, stream):
    """Run the body with ``dev`` as the current device and ``stream`` as
    its current stream (nothing to enter on the CPU)."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


class Mesh:
    """A (block, ctx) grid of torch devices, each entry a shard with its
    own CUDA stream."""

    def __init__(self, devices: Sequence, ctx_shards: int = 1):
        devs = [torch.device(d) for d in devices]
        if not devs or len(devs) % ctx_shards:
            raise ValueError("n_devices must be divisible by ctx_shards")
        nb = len(devs) // ctx_shards
        self.grid = [devs[b * ctx_shards:(b + 1) * ctx_shards]
                     for b in range(nb)]
        self.shape = {"block": nb, "ctx": ctx_shards}
        self.streams = [[_stream(d) for d in row] for row in self.grid]

    @property
    def devices(self) -> List[torch.device]:
        return [d for row in self.grid for d in row]

    def shard(self, b: int, c: int):
        """Context of shard (b, c): its device and stream."""
        return on_shard(self.grid[b][c], self.streams[b][c])

    def run(self, shards, fn) -> list:
        """fn(b, c) for each (b, c) of ``shards``, each on its shard's
        device and stream; the shard streams first wait for the caller's
        streams (the inputs), the caller's for the shards' (the
        outputs)."""
        pairs = list(shards)
        for b, c in pairs:
            s = self.streams[b][c]
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(self.grid[b][c]))
        out = []
        for b, c in pairs:
            with self.shard(b, c):
                out.append(fn(b, c))
        for b, c in pairs:
            s = self.streams[b][c]
            if s is not None:
                torch.cuda.current_stream(self.grid[b][c]).wait_stream(s)
        return out


def make_mesh(n_devices: Optional[int] = None, ctx_shards: int = 1,
              kind: str = "cuda") -> Mesh:
    devs = visible_devices(kind)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    if n % ctx_shards:
        raise ValueError("n_devices must be divisible by ctx_shards")
    return Mesh(devs[:n], ctx_shards)


def block_devices(mesh_n: int, clamp: bool = False,
                  kind: str = "cuda") -> Optional[List[torch.device]]:
    """The block-DP device list of CodecParams.mesh_n (0 = off, -1 = every
    visible device, N = the first N), or None when block-DP is a no-op
    (one device).  N over the visible count raises, or with ``clamp``
    (decode) takes them all."""
    if not mesh_n:
        return None
    devs = visible_devices(kind)
    n = len(devs) if mesh_n < 0 else mesh_n
    if n > len(devs):
        if not clamp:
            raise ValueError(
                f"--mesh {n}: only {len(devs)} device(s) visible")
        n = len(devs)
    if n <= 1:
        return None
    return make_mesh(n, kind=kind).devices


def device_cycled(devices, fn):
    """Wrap a per-block work fn(i, item, device) so block i runs with
    device i % N and a CUDA stream of its own as the current ones (the
    block's kernels and copies land there) and gets device=that device;
    identity when devices is None."""
    if not devices:
        return fn
    devs = [torch.device(d) for d in devices]
    streams = [_stream(d) for d in devs]
    n = len(devs)

    def wrapped(i, item):
        with on_shard(devs[i % n], streams[i % n]):
            return fn(i, item, device=devs[i % n])

    return wrapped


# --- collectives over one mesh axis (a list of per-shard tensors) -----------

def _reduce(parts: Sequence[torch.Tensor], op, unsigned: bool = False):
    dst = parts[0].device
    key = kernels._u32 if unsigned else (lambda t: t)
    acc = key(parts[0])
    for p in parts[1:]:
        acc = op(acc, key(p.to(dst)))
    if unsigned:
        acc = kernels._to_i32(acc)
    return [acc if p.device == dst else acc.to(p.device) for p in parts]


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards' tensors, a copy on each shard's device."""
    return _reduce(parts, torch.add)


def pmin(parts: Sequence[torch.Tensor],
         unsigned: bool = False) -> List[torch.Tensor]:
    """The elementwise minimum (u32 order for int32 tensors holding u32
    values with ``unsigned``), a copy on each shard's device."""
    return _reduce(parts, torch.minimum, unsigned)


def pmax(parts: Sequence[torch.Tensor],
         unsigned: bool = False) -> List[torch.Tensor]:
    """The elementwise maximum, as :func:`pmin`."""
    return _reduce(parts, torch.maximum, unsigned)


# --- B15, B19, B16: block data-parallel library functions --------------------

def _block_rows(mesh: Mesh, B: int) -> List[range]:
    nb = mesh.shape["block"]
    if B % nb:
        raise ValueError(f"B={B} not divisible by block axis {nb}")
    per = B // nb
    return [range(b * per, (b + 1) * per) for b in range(nb)]


def _on(dev: torch.device, a) -> torch.Tensor:
    """A tensor or a numpy array on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    arr = np.ascontiguousarray(a)
    if not arr.flags.writeable:           # e.g. a view of a JAX array
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


def train_counts_sharded(mesh: Mesh, model, syms, cgrid,
                         ctxg=None) -> List[torch.Tensor]:
    """Frozen-model training over a mesh (fastqueeze_tpu/parallel/mesh.py
    train_counts_sharded, B15).  syms (B, T, L) uint8 and cgrid (B, J, L)
    int32 stacked block grids (ctxg (B, T, L) int32 for FlatModel), B
    split over the 'block' axis.  Each block shard adds the histogram x
    inc of its blocks into a table of its own (K13's histogram half);
    then the row pass reduces the tables over 'block' onto the 'ctx'
    shards of block row 0 and adds init and halves (K13's row half): one
    launch a device, over the row block of the ctx shards it holds (other
    cards' partials of that block copied to it first), which sums the
    partials in the pass (train_rows_sum; with one block shard in place
    on its table, train_rows).  Returns the table's row blocks, ctx shard
    c's on its device (the shards of one device views of one tensor)."""
    nc = mesh.shape["ctx"]
    if model.n_ctx % nc:
        raise ValueError(f"n_ctx={model.n_ctx} not divisible by ctx={nc}")
    rows = _block_rows(mesh, len(syms))

    def hist(b, _c):
        dev = mesh.grid[b][0]
        h = torch.zeros((model.n_ctx, model.alphabet), dtype=torch.int32,
                        device=dev)
        for i in rows[b]:
            kernels.train_hist(_on(dev, syms[i]), _on(dev, cgrid[i]), model,
                               h, None if ctxg is None else _on(dev, ctxg[i]))
        return h

    hists = mesh.run([(b, 0) for b in range(len(rows))], hist)
    n = model.n_ctx // nc
    devs = mesh.grid[0]
    groups = _device_groups(devs)

    def finalize(_b, c0):
        g = next(g for g in groups if g[0] == c0)
        parts = [h[c0 * n:(g[-1] + 1) * n].to(devs[c0]) for h in hists]
        if len(parts) == 1:
            return kernels.train_rows(parts[0], model)
        return kernels.train_rows_sum(parts, model)

    done = mesh.run([(0, g[0]) for g in groups], finalize)
    return [t[i * n:(i + 1) * n] for g, t in zip(groups, done)
            for i in range(len(g))]


def encode_blocks_sharded(mesh: Mesh, model, n_halve: int, counts0, syms,
                          cgrid):
    """Data-parallel block coding (fastqueeze_tpu/parallel/mesh.py
    encode_blocks_sharded, B19): every block shard runs the adaptive walk
    (K5) from a copy of ``counts0`` ((n_ctx, A) int32, or None for init)
    and the reverse rANS (K7) over its blocks.  Returns per block
    ((T, L) int16 words, (T, L) uint8 emit, (L,) int32 final states), each
    on its shard's device."""
    rows = _block_rows(mesh, len(syms))

    def enc(b, _c):
        dev = mesh.grid[b][0]
        c0 = None if counts0 is None else _on(dev, counts0).to(torch.int32)
        out = []
        for i in rows[b]:
            s, cg = _on(dev, syms[i]), _on(dev, cgrid[i])
            sf = kernels.adapt_encode_walk(s, cg, model, n_halve, None, c0)
            out.append(kernels.rans_encode_sf(sf, cg))
        return out

    return [r for part in mesh.run([(b, 0) for b in range(len(rows))], enc)
            for r in part]


def align_blocks_sharded(mesh: Mesh, aligner, cfg, codes, dege, lengths):
    """Data-parallel alignment (fastqueeze_tpu/parallel/mesh.py
    align_blocks_sharded, B16): the index is copied to every block
    shard's device once (Aligner.dev_index) and each shard runs K8 over
    its blocks.  codes (B, R, Lp) uint8, dege (B, R, Lp) bool, lengths
    (B, R) int32.  Returns per block (mapped, pos, is_rev, mis_mask) on
    its shard's device."""
    rows = _block_rows(mesh, len(codes))

    def run(b, _c):
        dev = mesh.grid[b][0]
        ix = aligner.dev_index(dev)
        return [kernels.align_batch(_on(dev, codes[i]), _on(dev, dege[i]),
                                    _on(dev, lengths[i]).to(torch.int32),
                                    ix, cfg)
                for i in rows[b]]

    return [r for part in mesh.run([(b, 0) for b in range(len(rows))], run)
            for r in part]


# --- B18: the ctx-sharded frozen decode (K18) --------------------------------

def _device_groups(devs: Sequence[torch.device]) -> List[List[int]]:
    """The ctx shards of a block row grouped by device: each group the
    adjacent shard indices on one device, in shard order."""
    groups: List[List[int]] = []
    for c, d in enumerate(devs):
        if groups and devs[groups[-1][0]] == d:
            groups[-1].append(c)
        elif any(devs[g[0]] == d for g in groups):
            raise ValueError("a device's ctx shards must be adjacent")
        else:
            groups.append([c])
    return groups

def decode_frozen_sharded_stream(mesh: Mesh, b: int, states0, words, cgrid,
                                 T: int, cums, model):
    """One stream decoded by block row ``b`` of ``mesh``, whose ctx shard
    c holds ``cums[c]`` (the (n_ctx / D, A + 1) int16 rows of the
    quantized table on its device).  Returns ((T, L) uint8 symbols, (L,)
    int32 final states) on the row's first device.  Shards on one card
    (or all on the CPU): one K18 call; shards on several cards: one K18
    wave step a card at a time, each card's one (1, 3, L) partial summed
    over the cards (psum) between the steps."""
    devs = mesh.grid[b]
    st, wd, cg = (_on(devs[0], a) for a in (states0, words, cgrid))
    groups = _device_groups(devs)
    if len(groups) == 1:
        return mesh.run([(b, 0)], lambda _b, _c: kernels.ctx_shard_decode(
            st, wd, cg, T, list(cums), model))[0]

    def make(_b, c0):
        g = next(g for g in groups if g[0] == c0)
        dev = devs[c0]
        return kernels.ShardDecode(
            _on(dev, st), _on(dev, wd), _on(dev, cg), T,
            [cums[c] for c in g], model, shard0=c0, writer=c0 == 0)

    heads = [(b, g[0]) for g in groups]
    runs = dict(zip((g[0] for g in groups), mesh.run(heads, make)))
    xin = dict.fromkeys(runs)
    for t in range(T + 1):
        outs = mesh.run(heads, lambda _b, c0: runs[c0].step(t, xin[c0]))
        if t < T:
            xin = dict(zip(runs, psum(outs)))
    return runs[0].out, runs[0].x


def shard_tables(mesh: Mesh, b: int, counts0) -> List[torch.Tensor]:
    """Row c of the quantized table of raw ``counts0`` ((n_ctx, A)) on
    ctx shard (b, c)'s device, quantized there by K1 (quantization is
    row-local, so it commutes with the sharding)."""
    nc = mesh.shape["ctx"]
    n = counts0.shape[0] // nc
    c0 = np.ascontiguousarray(counts0)
    return mesh.run([(b, c) for c in range(nc)], lambda _b, c: (
        kernels.quant_pack(_on(mesh.grid[b][c],
                               np.ascontiguousarray(c0[c * n:(c + 1) * n],
                                                    np.int32)))[0]))


def decode_blocks_frozen_sharded(mesh: Mesh, model, counts0, states, words,
                                 cgrid, T: int):
    """Frozen wave decode with the quantized table sharded over the 'ctx'
    axis (fastqueeze_tpu/parallel/mesh.py decode_blocks_frozen_sharded /
    _build_frozen_sharded, B18) through K18.  counts0: the (n_ctx, A) raw
    counts (each ctx shard quantizes its rows with K1); states (B, L)
    int32 (u32 bits), words (B, W) int16 (u16 bits, zero-padded), cgrid
    (B, J, L) int32; B split over 'block'.  Returns ((B, T, L) uint8
    symbols, (B, L) int32 final states) on the CPU."""
    D = mesh.shape["ctx"]
    if model.n_ctx % D:
        raise ValueError(f"n_ctx={model.n_ctx} not divisible by ctx={D}")
    rows = _block_rows(mesh, len(states))
    syms, xs = [], []
    for b, rs in enumerate(rows):
        cums = shard_tables(mesh, b, np.asarray(counts0))
        for i in rs:
            s, x = decode_frozen_sharded_stream(mesh, b, states[i], words[i],
                                                cgrid[i], T, cums, model)
            syms.append(s.cpu())
            xs.append(x.cpu())
    return torch.stack(syms), torch.stack(xs)


_STREAM_MESH: Dict[tuple, Mesh] = {}


def ctx_mesh(devices: Sequence) -> Mesh:
    """The (1, D) mesh of a ctx_shard device list, made once a list (its
    shard streams are reused by every block of a run)."""
    key = tuple(str(torch.device(d)) for d in devices)
    m = _STREAM_MESH.get(key)
    if m is None:
        m = _STREAM_MESH[key] = Mesh(devices, ctx_shards=len(devices))
    return m


# --- B17: the index-sharded aligner (K19) ------------------------------------

def shard_ref_index(idx, n_shards: int) -> Dict:
    """Partition a RefIndex CSR into equal-key-count range shards
    (fastqueeze_tpu/parallel/mesh.py shard_ref_index): keys padded to a
    common kp with the sentinel 0xFFFFFFFF (above any valid key word), so
    the binary search needs no per-shard length; u32 positions (up to 4 G
    reference bases); the 2-bit packed reference stays whole."""
    if idx.ref_len >= (1 << 32):
        raise ValueError(
            f"reference has {idx.ref_len} bases; the sharded index "
            "carries u32 coordinates (supports references up to 4 Gbp)")
    keys = idx.keys.astype(np.uint64)
    nk = len(keys)
    bounds = [(i * nk) // n_shards for i in range(n_shards + 1)]
    kp = max((bounds[i + 1] - bounds[i] for i in range(n_shards)),
             default=1) or 1
    pp = max((int(idx.offsets[bounds[i + 1]] - idx.offsets[bounds[i]])
              for i in range(n_shards)), default=1) or 1
    keys_hi = np.full((n_shards, kp), 0xFFFFFFFF, np.uint32)
    keys_lo = np.full((n_shards, kp), 0xFFFFFFFF, np.uint32)
    offsets = np.zeros((n_shards, kp + 1), np.int32)
    positions = np.zeros((n_shards, pp), np.uint32)
    wide = idx.k > 15
    for s in range(n_shards):
        a, b = bounds[s], bounds[s + 1]
        n = b - a
        ks = keys[a:b]
        if wide:
            keys_hi[s, :n] = (ks >> np.uint64(30)).astype(np.uint32)
            keys_lo[s, :n] = (ks & np.uint64(0x3FFFFFFF)).astype(np.uint32)
        else:
            keys_hi[s, :n] = ks.astype(np.uint32)
        po, pb = int(idx.offsets[a]), int(idx.offsets[b])
        offsets[s, :n + 1] = idx.offsets[a:b + 1] - po
        offsets[s, n + 1:] = offsets[s, n]
        positions[s, :pb - po] = idx.positions[po:pb]
    return {"keys_hi": keys_hi, "keys_lo": keys_lo, "offsets": offsets,
            "positions": positions, "packed": idx.packed.astype(np.uint32),
            "ref_len": idx.ref_len, "k": idx.k, "kp": kp}


def _shard_index(mesh: Mesh, sh: Dict) -> List[List[kernels.ShardIndex]]:
    """Each block row's index shards on their devices, uploaded once a
    mesh (cached in ``sh``): a ShardIndex a device group of the row
    (_device_groups), its shards stacked, so each K19 phase runs a
    device's shards in one launch."""
    key = tuple(str(d) for d in mesh.devices)
    cache = sh.setdefault("_dev", {})
    if key not in cache:
        steps = max(1, math.ceil(math.log2(sh["kp"] + 1)))
        i32 = lambda a: np.ascontiguousarray(a).view(np.int32)  # noqa: E731
        packed = {}

        def put(b, g):
            dev = mesh.grid[b][g[0]]
            if dev not in packed:        # one reference copy a device
                packed[dev] = _on(dev, i32(sh["packed"]))
            rows = slice(g[0], g[-1] + 1)
            return kernels.ShardIndex(
                *(_on(dev, i32(sh[n][rows])) for n in
                  ("keys_hi", "keys_lo", "offsets", "positions")),
                packed[dev], sh["ref_len"], sh["k"], steps)

        cache[key] = [[put(b, g) for g in _device_groups(mesh.grid[b])]
                      for b in range(mesh.shape["block"])]
    return cache[key]


def _one_strand_sharded(mesh: Mesh, b: int, sxs, grids, stride: int,
                        n_seeds: int, C: int, excl_bp: int, rc: bool):
    """_one_strand's shard_axis branch over block row b, a launch a phase
    and device (``sxs`` / ``grids``: a device group's stacked index and
    its read grids): the lookup, pmin; the candidates, pmax; the verify
    of each shard's slice, pmin of mis then of pos among the mis
    minimizers; each collective a reduction over the device's stacked
    shards, then across the devices.  Returns the global (mis, u32 pos)
    on the row's first device."""
    D = mesh.shape["ctx"]
    Cs = -(-(n_seeds * C) // D)
    groups = _device_groups(mesh.grid[b])
    heads = [(b, g[0]) for g in groups]
    at = {g[0]: i for i, g in enumerate(groups)}
    u32, i32 = kernels._u32, kernels._to_i32
    look = mesh.run(heads, lambda _b, c: kernels.sharded_lookup(
        *grids[at[c]], sxs[at[c]], stride, rc))
    occ = pmin([o[0].amin(0) for o in look])
    cands = mesh.run(heads, lambda _b, c: kernels.sharded_candidates(
        occ[at[c]], look[at[c]][1], look[at[c]][2], sxs[at[c]], stride,
        n_seeds, C, excl_bp))
    cand = pmax([i32(u32(x[0]).amax(0)) for x in cands], unsigned=True)
    owner = [o > 0 for o in pmax([x[2].any(0).to(torch.int32)
                                  for x in cands])]
    ver = mesh.run(heads, lambda _b, c: kernels.sharded_verify(
        grids[at[c]][0], grids[at[c]][2], cand[at[c]], cands[at[c]][1][0],
        owner[at[c]], C, sxs[at[c]].ref_len, c * Cs, Cs, sxs[at[c]].packed,
        rc, shards=len(groups[at[c]])))
    best = [v[0].amin(0) for v in ver]
    first = [i32(torch.where(v[0] == m, u32(v[1]), 0xFFFFFFFF).amin(0))
             for v, m in zip(ver, best)]
    mis = pmin(best)
    pos = pmin([torch.where(f == m, p, -1)
                for f, m, p in zip(best, mis, first)], unsigned=True)
    return mis[0], pos[0]


def align_blocks_index_sharded(mesh: Mesh, params, sh: Dict, codes, dege,
                               lengths, n_seeds: int = 1, excl_bp: int = 0,
                               n_cand: Optional[int] = None):
    """Alignment with the k-mer index sharded over the 'ctx' axis and reads
    split over 'block' (fastqueeze_tpu/parallel/mesh.py
    align_blocks_index_sharded, B17) through K19: gapless, both strands,
    u32 window starts.  codes (R, Lp) uint8, dege (R, Lp) bool, lengths
    (R,) (numpy arrays or tensors); R divisible by the block axis.
    Returns numpy (mapped, pos uint32, is_rev, mis_mask)."""
    R, lp = codes.shape
    rows = _block_rows(mesh, R)
    C = n_cand or params.seed_max_occ
    sxs_all = _shard_index(mesh, sh)
    outs = []
    for b, rs in enumerate(rows):
        sl = slice(rs.start, rs.stop)
        sxs = sxs_all[b]
        grids = [(_on(dev, codes[sl]).to(torch.uint8),
                  _on(dev, dege[sl]).to(torch.bool),
                  _on(dev, lengths[sl]).to(torch.int32))
                 for dev in (mesh.grid[b][g[0]]
                             for g in _device_groups(mesh.grid[b]))]
        strands = [_one_strand_sharded(mesh, b, sxs, grids,
                                       params.seed_stride, n_seeds, C,
                                       excl_bp, rc)
                   for rc in (False, True)]
        res = mesh.run([(b, 0)], lambda _b, _c: kernels.sharded_tail(
            *grids[0], "both", params.both_strands, params.max_mis,
            sh["k"], strands[0], strands[1], sxs[0].packed))[0]
        outs.append([t.cpu().numpy() for t in res])
    mapped, pos, rev, mm = (np.concatenate(x) for x in zip(*outs))
    return mapped, pos.view(np.uint32), rev, mm
