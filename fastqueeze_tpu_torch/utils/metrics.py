"""Per-run metrics accumulation (parity: reference DebugInfo, SURVEY.md C18
— per-stage timers, per-stream sizes, mapping histograms, printed as tables
after each run via printEncodeDebugInfo @0x41a930).

A stage is timed as a span: ``with dbg.span("codec.ids"):`` adds the
block's seconds to ``vals["codec.ids_s"]`` and 1 to ``vals["codec.ids_n"]``.
While torch.profiler records, the span is also the range ``fq.codec.ids``
on the thread that runs it, so a profile (``--profile``, a benchmark's
traced job) shows each stage on the device trace's clock.  A name's
first part is its parent stage (``train.hist`` inside ``train``,
``parse.md5`` inside ``parse``) or its layer (``codec.*``: the block
codec, ``native.*``: the native host coders); ``read``, ``md5`` and
``write`` run wherever the driver reads, hashes or writes.  The stages
that had their own timers before spans (``LEGACY``) keep their keys as
they were: seconds, no ``_n``.  ``spanned_s`` sums the outermost spans
on the thread that made the table: a call's time less it is time that
no stage accounts for.

Modules that take no ``DebugInfo`` (the native host coders, the frozen
trainer's memos) time and count into the innermost span open on their
thread through :func:`span` and :func:`count`: outside every span they
record nothing.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from contextlib import nullcontext
from typing import Dict, Optional

from torch.autograd import profiler as _torch_profiler

LEGACY = frozenset({"train", "parse", "dispatch", "encode", "decode",
                    "selfref_probe", "selfref", "align", "ref"})
SPANNED = "spanned_s"

_open = threading.local()      # .stack: the spans open on this thread


def _stack() -> list:
    st = getattr(_open, "stack", None)
    if st is None:
        st = _open.stack = []
    return st


class _Span:
    __slots__ = ("dbg", "name", "stack", "rf", "t0")

    def __init__(self, dbg: "DebugInfo", name: str):
        self.dbg = dbg
        self.name = name

    def __enter__(self):
        self.stack = _stack()
        self.stack.append(self)
        self.rf = (_torch_profiler.record_function("fq." + self.name)
                   if _torch_profiler._is_profiler_enabled else None)
        # the clock is read before entering the range and before leaving
        # it, so that the range and the seconds begin and end alike
        self.t0 = time.perf_counter()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        self.dbg._close(self.name, dt, outer=not any(
            s.dbg is self.dbg for s in self.stack))
        return False


class DebugInfo:
    def __init__(self):
        self.vals: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self._owner = threading.get_ident()

    def add(self, key: str, v: float) -> None:
        with self._lock:
            self.vals[key] += v

    def set(self, key: str, v: float) -> None:
        self.vals[key] = v

    def span(self, name: str) -> _Span:
        """Time the ``with`` block as the stage ``name`` (see the module
        docstring)."""
        return _Span(self, name)

    def _close(self, name: str, dt: float, outer: bool) -> None:
        with self._lock:
            self.vals[name + "_s"] += dt
            if name not in LEGACY:
                self.vals[name + "_n"] += 1
            if outer and threading.get_ident() == self._owner:
                self.vals[SPANNED] += dt

    def table(self) -> str:
        if not self.vals:
            return "(no metrics)"
        w = max(len(k) for k in self.vals)
        lines = [f"  {k.ljust(w)}  {v:,.3f}" for k, v in sorted(self.vals.items())]
        return "\n".join(lines)

    def print(self, title: str = "metrics") -> None:
        sys.stderr.write(f"--- {title} ---\n{self.table()}\n")


def current() -> Optional[DebugInfo]:
    """The DebugInfo of the innermost span open on this thread."""
    st = _stack()
    return st[-1].dbg if st else None


def stage(dbg: Optional[DebugInfo], name: str):
    """``dbg.span(name)``, or nothing where the caller keeps no table."""
    return dbg.span(name) if dbg is not None else nullcontext()


def span(name: str):
    """The stage ``name`` in the table of the innermost open span."""
    return stage(current(), name)


def count(key: str, v: float = 1) -> None:
    """Add ``v`` to ``key`` in the table of the innermost open span."""
    dbg = current()
    if dbg is not None:
        dbg.add(key, v)
