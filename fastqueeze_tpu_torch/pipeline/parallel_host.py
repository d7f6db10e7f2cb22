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

T = TypeVar("T")
R = TypeVar("R")


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
