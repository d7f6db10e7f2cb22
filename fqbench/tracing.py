"""The traced job of a ``--trace 1`` run and the reduction of its trace.

After the set-up job, one whole job runs under torch.profiler (host and
device activity) with the harness's own spans: ``fqbench.compress`` and
``fqbench.decompress`` around the two calls, and ``fqk.<kernel>#<i>``
around every call of a kernel wrapper of the port's ``ops/kernels.py``
that ``kernels.LAUNCHES`` names.  Each such call's arguments and results
are kept as shapes (and small tensors), so that ``counts/<kernel>.py``
can give the bytes and operations that the call's inputs need.

Every kernel record is tied to its launch by the trace's correlation id,
and each launch to the innermost wrapper span around it on its thread.
A launch without a kernel record, or a wrapper whose launches the trace
does not hold as often as ``LAUNCHES`` counted them, fails the run: the
profiler has lost device records.
"""

from __future__ import annotations

import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from fqbench import harness

PHASES = ("compress", "decompress")
SPAN = "fqbench.{}"
KSPAN = re.compile(r"^fqk\.(\w+)#(\d+)$")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# tensors up to this size are kept whole for the counts (read-back
# lengths, counters); larger ones only by shape
SMALL_BYTES = 8 << 20


@dataclass
class TensorInfo:
    """A tensor argument or result of a kernel call: its shape, type and
    bytes, and the tensor itself where it is small."""
    shape: Tuple[int, ...]
    dtype: str
    numel: int
    nbytes: int
    value: object = None

    def total(self) -> int:
        """The sum of a kept tensor's elements."""
        if self.value is None:
            raise ValueError(f"tensor {self.shape} was not kept")
        return int(self.value.long().sum().item())


def describe(x):
    import torch
    if isinstance(x, torch.Tensor):
        nb = x.numel() * x.element_size()
        return TensorInfo(tuple(x.shape), str(x.dtype), x.numel(), nb,
                          x.detach() if nb <= SMALL_BYTES else None)
    if isinstance(x, (tuple, list)):
        return type(x)(describe(v) for v in x)
    if isinstance(x, dict):
        return {k: describe(v) for k, v in x.items()}
    return x


@dataclass
class Call:
    kernel: str
    index: int
    args: tuple
    kwargs: dict
    out: object


class Recorder:
    """Wraps the port's kernel wrappers (the functions of
    ``fastqueeze_tpu_torch.ops.kernels`` named by ``LAUNCHES``: every
    caller reaches them as module attributes) in a span each, and keeps
    each call's shapes."""

    def __init__(self):
        self.calls: List[Optional[Call]] = []
        self._orig: Dict[str, object] = {}
        self.names: List[str] = []

    def install(self) -> None:
        from fastqueeze_tpu_torch.ops import kernels
        for name in kernels.LAUNCHES:
            fn = getattr(kernels, name, None)
            if callable(fn):
                self._orig[name] = fn
                self.names.append(name)
                setattr(kernels, name, self._wrap(name, fn))

    def remove(self) -> None:
        from fastqueeze_tpu_torch.ops import kernels
        for name, fn in self._orig.items():
            setattr(kernels, name, fn)
        self._orig.clear()

    def _wrap(self, name, fn):
        from torch.profiler import record_function

        def wrapped(*args, **kwargs):
            i = len(self.calls)
            self.calls.append(None)
            with record_function(f"fqk.{name}#{i}"):
                out = fn(*args, **kwargs)
            self.calls[i] = Call(name, i, describe(args), describe(kwargs),
                                 describe(out))
            return out
        wrapped.__wrapped__ = fn
        return wrapped


@dataclass
class Launch:
    """One kernel-wrapper call of a phase: its device time (the kernel
    records its launches made) and its bound, where counts/ has a file."""
    kernel: str
    device_us: float
    bound_us: Optional[float]


@dataclass
class Phase:
    name: str
    lo_us: float
    hi_us: float
    records: List[tuple] = field(default_factory=list)
    launches: List[Launch] = field(default_factory=list)

    @property
    def window_ms(self) -> float:
        return (self.hi_us - self.lo_us) / 1e3

    def ms_of(self, cat: str) -> float:
        return sum(b - a for a, b, _, c in self.records if c == cat) / 1e3

    @property
    def busy_ms(self) -> float:
        return busy_ms([(a, b) for a, b, _, _ in self.records],
                       self.lo_us, self.hi_us)


@dataclass
class Traced:
    phases: Dict[str, Phase]
    busy_s: float
    window_s: float
    top_ops: List[list]
    idle_gaps: List[list]


def busy_ms(ivs, lo: float, hi: float) -> float:
    """The union of the intervals (us) clipped to [lo, hi), in ms
    (copied from chip_smoke.py ``_busy_ms`` at commit 754d661)."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in ivs
                       if b > lo and a < hi):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def kernel_short(name: str) -> str:
    """A trace's kernel name without its namespace and arguments (from
    chip_smoke.py ``_kernel_short`` at commit 754d661, which kept
    anonymous namespaces)."""
    name = name.replace("(anonymous namespace)::", "")
    hit = re.search(r"(\w+)(<[^()]*>)?\(", name)
    return hit.group(1) + (hit.group(2) or "") if hit else name[:60]


def _is_launch(name: str) -> bool:
    return "Launch" in name and "Host" not in name


def reduce_trace(evs: list, calls: List[Call], launches_delta: Dict[str, int],
                 peaks: Dict, bench_dir: str = harness.BENCH_DIR) -> Traced:
    """Phases, launches with their device time and bound, busy and idle
    from the Chrome trace events of one traced job.  ``launches_delta``:
    the job's ``LAUNCHES`` counts of the wrapped kernels."""
    xs = [e for e in evs if e.get("ph") == "X"]
    spans = {e["name"]: e for e in xs if e.get("cat") == "user_annotation"
             and e.get("name") in [SPAN.format(p) for p in PHASES]}
    if len(spans) != len(PHASES):
        raise RuntimeError(f"trace: phase spans found {sorted(spans)}")
    phases = {p: Phase(p, spans[SPAN.format(p)]["ts"],
                       spans[SPAN.format(p)]["ts"]
                       + spans[SPAN.format(p)]["dur"]) for p in PHASES}
    lo = min(ph.lo_us for ph in phases.values())
    hi = max(ph.hi_us for ph in phases.values())
    devrec = [(e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""),
               e["cat"], (e.get("args") or {}).get("correlation"))
              for e in xs if e.get("cat") in DEVICE_CATS]
    by_corr: Dict[object, List[tuple]] = {}
    for r in devrec:
        if r[3] == "kernel":
            by_corr.setdefault(r[4], []).append(r)
    kspans = []
    for e in xs:
        m = KSPAN.match(e.get("name", "")) if e.get(
            "cat") == "user_annotation" else None
        if m:
            kspans.append((e["ts"], e["ts"] + e["dur"], e.get("pid"),
                           e.get("tid"), m.group(1), int(m.group(2))))
    runtime = [e for e in xs if e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver")
               and _is_launch(e.get("name", ""))
               and lo <= e["ts"] <= hi]
    missing = [e["name"] for e in runtime
               if (e.get("args") or {}).get("correlation") not in by_corr]
    if missing:
        raise RuntimeError(f"trace: {len(missing)} of {len(runtime)} kernel "
                           f"launches have no device record (the profiler "
                           f"lost them)")
    span_us: Dict[int, float] = {}
    span_launched: Dict[int, int] = {}
    for e in runtime:
        inner = None
        for a, b, pid, tid, name, i in kspans:
            if (pid, tid) == (e.get("pid"), e.get("tid")) and a <= e[
                    "ts"] <= b and (inner is None or b - a < inner[1]):
                inner = (i, b - a)
        if inner is None:
            continue
        i = inner[0]
        span_launched[i] = span_launched.get(i, 0) + 1
        span_us[i] = span_us.get(i, 0.0) + sum(
            r[1] - r[0] for r in by_corr[e["args"]["correlation"]])
    seen: Dict[str, int] = {}
    for i, n in span_launched.items():
        seen[calls[i].kernel] = seen.get(calls[i].kernel, 0) + n
    short = {k: (v, seen.get(k, 0)) for k, v in launches_delta.items()
             if seen.get(k, 0) < v}
    if short:
        raise RuntimeError(f"trace: launches in the wrappers' spans fewer "
                           f"than LAUNCHES counted: {short}")
    counters = {}
    for a, b, pid, tid, name, i in kspans:
        if i not in span_launched:
            continue
        if name not in counters:
            counters[name] = harness.load_counts(name, bench_dir)
        count = counters[name]
        bound = None
        if count is not None:
            nbytes, ops = count(calls[i])
            bound = max(nbytes / peaks["hbm_bytes_per_s"],
                        ops / peaks["int32_ops_per_s"]) * 1e6
        for ph in phases.values():
            if ph.lo_us <= a < ph.hi_us:
                ph.launches.append(Launch(name, span_us[i], bound))
    for ph in phases.values():
        ph.records = [(max(a, ph.lo_us), min(b, ph.hi_us), n, c)
                      for a, b, n, c, _ in devrec
                      if b > ph.lo_us and a < ph.hi_us]
    by_name: Dict[str, float] = {}
    for a, b, n, c, _ in devrec:
        if b > lo and a < hi:
            k = kernel_short(n) if c == "kernel" else n
            by_name[k] = by_name.get(k, 0.0) + (min(b, hi) - max(a, lo)) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for ph in phases.values():
        end, after = ph.lo_us, "the call's start"
        for a, b, n, c in sorted(ph.records):
            if a > end:
                gaps.append([f"{ph.name} call, after {after}",
                             (a - end) / 1e6])
            if b > end:
                end = b
                after = kernel_short(n) if c == "kernel" else n
        if ph.hi_us > end:
            gaps.append([f"{ph.name} call, after {after} (to the call's "
                         f"end)", (ph.hi_us - end) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    busy = busy_ms([(a, b) for a, b, _, _, _ in devrec], lo, hi) / 1e3
    return Traced(phases, busy, (hi - lo) / 1e6,
                  [[k, v] for k, v in top], gaps[:10])


def traced_job(cell, work: str, inp, device: str,
               control: Optional[str] = None):
    """Job 1 under torch.profiler with the spans above; returns ([job],
    Traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from fastqueeze_tpu_torch.ops import kernels
    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    rec = Recorder()
    rec.install()
    before = dict(kernels.LAUNCHES)
    path = os.path.join(work, "trace.json")
    try:
        with profile(activities=acts) as prof:
            job = harness.run_job(cell, work, inp, 1, device, control,
                                  span=record_function)
            if device.startswith("cuda"):
                torch.cuda.synchronize()
    finally:
        rec.remove()
    if job.error:
        return [job], None
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            tr = json.load(fh)
    finally:
        os.remove(path)
    evs = tr["traceEvents"] if isinstance(tr, dict) else tr
    delta = {k: kernels.LAUNCHES[k] - before.get(k, 0) for k in rec.names}
    traced = reduce_trace(evs, rec.calls, delta, harness.load_peaks(
        cell.bench_dir), cell.bench_dir)
    return [job], traced


@dataclass
class Context:
    """What a per-layer metric's reader reads: the traced job's input and
    restored megabytes, its two DebugInfo tables, and its two phases."""
    input_mb: float
    restored_mb: float
    dbg: Dict[str, Dict[str, float]]
    phases: Dict[str, Phase]


def per_layer(cell, job, traced: Optional[Traced]) -> (Dict, Dict):
    """The cell's per-layer metrics ({name: {value, unit}}; a reader that
    finds nothing is left out) and the breakdown."""
    if traced is None:
        return {}, {}
    ctx = Context(job.input_bytes / 1e6, job.restored_bytes / 1e6, job.dbg,
                  traced.phases)
    out = {}
    for m in cell.per_layer:
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            print(f"fqbench: {m['name']}: nothing to read", file=sys.stderr)
    return out, {"device_ops": traced.top_ops, "idle_gaps": traced.idle_gaps}
