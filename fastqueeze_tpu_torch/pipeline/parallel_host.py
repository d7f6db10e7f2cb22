"""Host-side block pipelining (reference C5/C6 parity: SeqArcRead reader
thread + ReadBufPool bounded queue + N encode/decode worker threads,
srcfile:SeqArcRead.cpp/BufPool.cpp).

One device stream, with the host stages (parse / MD5 / ID binning / host
range coding / transfers) of several blocks overlapped: a thread pool runs
the per-block stage function while the main thread consumes results
strictly in block order.  In-flight blocks are bounded (reference:
bufnum = 2*threads - 1)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

import torch

T = TypeVar("T")
R = TypeVar("R")

MESH_MSG = ("--mesh block data-parallelism over 2 or more devices: ROADMAP "
            "Queue A item 9")


def block_devices(mesh_n: int, device, clamp: bool = False) -> None:
    """Resolve CodecParams.mesh_n as fastqueeze_tpu's
    parallel/mesh.block_devices does (0 = off, -1 = every visible device,
    N = the first N) against the devices of ``device``'s kind
    (torch.cuda.device_count(), 1 for the CPU).  N over the visible count
    raises its ValueError, or with ``clamp`` (decode) takes them all.  One
    resolved device makes block data-parallelism a no-op (nothing to
    return, ``threads`` untouched, mesh_n still in PARAM); two or more
    are not ported."""
    if not mesh_n:
        return
    have = (torch.cuda.device_count()
            if torch.device(device).type == "cuda" else 1)
    n = have if mesh_n < 0 else mesh_n
    if n > have:
        if not clamp:
            raise ValueError(f"--mesh {n}: only {have} device(s) visible")
        n = have
    if n > 1:
        raise NotImplementedError(MESH_MSG)


def ordered_parallel(items: Iterable[T], fn: Callable[[int, T], R],
                     workers: int) -> Iterator[Tuple[int, R]]:
    """Run ``fn(idx, item)`` over items with ``workers`` threads, yielding
    results in submission order with at most ``2*workers - 1`` in flight."""
    if workers <= 1:
        for i, item in enumerate(items):
            yield i, fn(i, item)
        return
    max_inflight = 2 * workers - 1
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        it = enumerate(items)
        done = False
        while True:
            while not done and len(pending) < max_inflight:
                try:
                    i, item = next(it)
                except StopIteration:
                    done = True
                    break
                pending.append((i, pool.submit(fn, i, item)))
            if not pending:
                return
            i, fut = pending.pop(0)
            yield i, fut.result()
