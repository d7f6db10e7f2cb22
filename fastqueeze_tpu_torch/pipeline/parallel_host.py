"""Host-side block pipelining (reference C5/C6 parity: SeqArcRead reader
thread + ReadBufPool bounded queue + N encode/decode worker threads,
srcfile:SeqArcRead.cpp/BufPool.cpp).

The host stages (parse / MD5 / ID binning / host range coding /
transfers) of several blocks overlap: a thread pool runs the per-block
stage function while the main thread consumes results strictly in block
order.  In-flight blocks are bounded (reference: bufnum = 2*threads - 1).
With --mesh N (block data-parallelism) block i runs on device i % N, on a
CUDA stream of its own (parallel/mesh.device_cycled)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

import torch

from fastqueeze_tpu_torch.parallel.mesh import block_devices, device_cycled

T = TypeVar("T")
R = TypeVar("R")


def block_dp_devices(params, device):
    """Resolve the block-DP device set from ``params.mesh_n`` against the
    devices of ``device``'s kind and widen the host pipeline so every
    device has a feeding thread (before the archive's PARAM is written:
    a --mesh 4 archive carries threads = 4).  Returns None when no mesh
    is requested or it resolves to one device (plain host threading)."""
    if not params.mesh_n:
        return None
    devices = block_devices(params.mesh_n, kind=torch.device(device).type)
    if devices and params.threads < len(devices):
        params.threads = len(devices)
    return devices


def device_parallel(items: Iterable[T], fn: Callable[..., R], devices,
                    workers: int, device) -> Iterator[Tuple[int, R]]:
    """``ordered_parallel`` of ``fn(idx, item, device)`` with the blocks
    round-robined over ``devices`` (block-DP: whole blocks per device;
    payloads stay byte-identical to the single-device run), or every
    block on ``device`` when ``devices`` is None."""
    if devices:
        run = device_cycled(devices, fn)
    else:
        def run(i, item):
            return fn(i, item, device=device)
    return ordered_parallel(items, run, max(1, workers))


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
