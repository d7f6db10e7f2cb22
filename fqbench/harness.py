"""The benchmark's harness: cells found by name, the job loop, the window,
the check of every job's output, and the traced job.

A cell is a ``workloads`` entry of ``BENCHMARK.json``.  Everything that
belongs to one configuration, mix, per-layer metric or kernel sits in a
file of its own under this folder, found by its name:

    configs/<config>.json     entry point, flags, read generator
    mixes/<traffic>.json      the job's shape: reads, -t, the reference
    metrics/<metric>.py       read(ctx) -> value or None
    counts/<kernel>.py        count(call) -> (bytes, integer operations)
    reference/<name>.py       bytes_wrong(original, restored) -> int

so a later cell, configuration, mix, metric or reference is new files and
entries.  A key that the harness does not read is refused, not ignored
(``CONFIG_KEYS``, ``MIX_KEYS``, ``ENTRIES``, ``gen.KINDS``).

Every mix is compress-then-verify, one client in a closed loop: job k
writes the seed's files rotated by a job-specific number of records
(gen.RotatedInput: no two jobs compress the same file), compresses them
with the configuration's entry point (``ENTRIES``: the port's
``driver.compress_se`` or ``pe.compress_pe``), decompresses the archive
with ``driver.decompress`` into FIFOs that reader threads drain into
memory (no restored byte reaches the disk), and keeps the restored bytes
for the check made once the window has closed: the mix's reference
judges them, and the last job's files are compressed once more to hold
the archive to the guarantee that the same input and flags give the same
archive.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that the port's process may not hold: the JAX
# package and JAX itself (compared whole: the port's name begins with the
# JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fastqueeze_tpu")
# lossy quality factor of the control (the program's own -l path)
CONTROL_LOSSY = 1.15
# the keys of a configuration file and of a mix file: entry, params, reads,
# threads, reads_per_file and reference are read by the harness, the rest
# by people (file_size is the key that the manifest's ``reduced`` names)
CONFIG_KEYS = {"entry", "params", "reads",
               "deployment", "guarantees", "file_size", "assumed"}
MIX_KEYS = {"threads", "reads_per_file", "reference", "why"}
# entry point: (module, function, input files, suffixes of the files that
# driver.decompress restores under its prefix)
ENTRIES = {
    "compress_se": ("fastqueeze_tpu_torch.pipeline.driver", "compress_se",
                    1, (".fastq",)),
    "compress_pe": ("fastqueeze_tpu_torch.pipeline.pe", "compress_pe",
                    2, ("_1.fastq", "_2.fastq")),
}


# --- finding a cell's files by name ---------------------------------------

def load_manifest(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _load_module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of the manifest with its configuration, mix and
    metrics, read from the files their names point to."""
    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: str

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        return _load_module(path, "fqbench_metric_" + metric).read


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The workload ``name`` of ``root``'s BENCHMARK.json; its config
    file is the manifest's ``file`` (relative to ``root``) and its mix
    ``mixes/<traffic>.json`` under ``bench_dir``."""
    man = load_manifest(root)
    hits = [w for w in man["workloads"] if w["name"] == name]
    if len(hits) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: "
                       f"{', '.join(w['name'] for w in man['workloads'])})")
    w = hits[0]
    cfg = [c for c in man["configs"] if c["name"] == w["config"]]
    if len(cfg) != 1:
        raise KeyError(f"workload {name}: no config {w['config']!r}")
    with open(os.path.join(root, cfg[0]["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(bench_dir, "mixes", w["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    check_config(w["config"], config)
    check_mix(w["traffic"], mix, bench_dir)
    return Cell(name, int(w["chips"]), config, mix,
                [m for m in man["end_to_end"] if _applies(m, name)],
                [m for m in man["per_layer"] if _applies(m, name)],
                bench_dir)


def _refuse(what: str, got, known) -> None:
    extra = set(got) - set(known)
    if extra:
        raise ValueError(f"{what}: keys {sorted(extra)} are not read by the "
                         f"harness (known: {', '.join(sorted(known))})")


def check_config(name: str, config: Dict) -> None:
    """Refuses a configuration with a key, an entry point or a kind of
    reads that the harness does not know, or whose reads do not make the
    files its entry point takes."""
    from fqbench import gen
    _refuse(f"config {name}", config, CONFIG_KEYS)
    entry = config.get("entry")
    if entry not in ENTRIES:
        raise ValueError(f"config {name}: unknown entry {entry!r} (have: "
                         f"{', '.join(sorted(ENTRIES))})")
    files = gen.files_of(config.get("reads", {}))
    if files != ENTRIES[entry][2]:
        raise ValueError(f"config {name}: {entry} takes {ENTRIES[entry][2]} "
                         f"files, reads of kind {config['reads']['kind']!r} "
                         f"make {files}")


def check_mix(name: str, mix: Dict, bench_dir: str = BENCH_DIR) -> None:
    """Refuses a mix with a key the harness does not read, or whose
    reference has no file under reference/."""
    _refuse(f"mix {name}", mix, MIX_KEYS)
    for key in ("threads", "reads_per_file", "reference"):
        if key not in mix:
            raise ValueError(f"mix {name}: no {key!r}")
    if not os.path.exists(reference_path(mix["reference"], bench_dir)):
        raise ValueError(f"mix {name}: no reference/{mix['reference']}.py")


def reference_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "reference", name + ".py")


def load_counts(kernel: str, bench_dir: str = BENCH_DIR):
    """counts/<kernel>.py's ``count``, or None where the kernel has no
    file."""
    path = os.path.join(bench_dir, "counts", kernel + ".py")
    if not os.path.exists(path):
        return None
    return _load_module(path, "fqbench_counts_" + kernel).count


def load_peaks(bench_dir: str = BENCH_DIR) -> Dict:
    with open(os.path.join(bench_dir, "peaks.json")) as fh:
        return json.load(fh)


# --- the job ---------------------------------------------------------------

def make_params(cell: Cell, control: Optional[str] = None):
    """CodecParams as the CLI builds them from the configuration's flags
    (``params``: the fields those flags set) and the mix's ``-t``; a
    fresh object a job, since compress_se writes its auto self-align
    decision into it."""
    from fastqueeze_tpu_torch.config import CodecParams
    p = CodecParams()
    for key, val in cell.config.get("params", {}).items():
        if not hasattr(p, key):
            raise KeyError(f"config {cell.name}: CodecParams has no {key!r}")
        setattr(p, key, val)
    p.threads = int(cell.mix["threads"])
    if control == "lossy":
        p.lossy_factor = CONTROL_LOSSY
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    return p


class FifoSink:
    """A FIFO that a reader thread drains into a buffer of ``capacity``
    bytes (bytes past it are counted, not kept).  A second write end held
    open until :meth:`finish` keeps the reader from seeing an end before
    the decoder has opened the FIFO."""

    def __init__(self, path: str, capacity: int):
        self.path = path
        if not os.path.exists(path):
            os.mkfifo(path)
        self.buf = bytearray(capacity)
        self.n = 0
        self.overflow = 0
        self.error: Optional[BaseException] = None
        self._rfd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
        self._keep = os.open(path, os.O_WRONLY)
        os.set_blocking(self._rfd, True)
        with contextlib.suppress(OSError, AttributeError):
            import fcntl
            fcntl.fcntl(self._rfd, fcntl.F_SETPIPE_SZ, 1 << 20)
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        try:
            view = memoryview(self.buf)
            spill = bytearray(1 << 20)
            with open(self._rfd, "rb", buffering=0, closefd=False) as fh:
                while True:
                    if self.n < len(self.buf):
                        k = fh.readinto(view[self.n:])
                        self.n += k or 0
                    else:
                        k = fh.readinto(spill)
                        self.overflow += k or 0
                    if not k:
                        return
        except BaseException as e:      # reported by finish()
            self.error = e

    def finish(self, timeout: float = 120.0) -> memoryview:
        """Close the keeping write end, wait for the reader, and return
        the bytes received."""
        os.close(self._keep)
        self._thread.join(timeout)
        alive = self._thread.is_alive()
        os.close(self._rfd)
        if alive:
            raise RuntimeError(f"{self.path}: the reader did not end")
        if self.error is not None:
            raise RuntimeError(f"{self.path}: {self.error!r}")
        return memoryview(self.buf)[:self.n]


@dataclass
class Job:
    index: int = 0
    compress_s: float = 0.0
    decompress_s: float = 0.0
    input_bytes: int = 0
    archive_bytes: int = 0
    archive_sha256: str = ""
    wall_s: float = 0.0
    restored: Optional[List[memoryview]] = None
    restored_bytes: int = 0
    overflow: int = 0
    error: str = ""
    dbg: Dict[str, Dict[str, float]] = field(default_factory=dict)


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for piece in iter(lambda: fh.read(1 << 22), b""):
            h.update(piece)
    return h.hexdigest()


def _entry(cell: Cell) -> Tuple[Callable, int, Tuple[str, ...]]:
    """The configuration's entry point, looked up when called (so that
    the tests' planted faults take effect), its file count and the
    suffixes of what decompress restores."""
    mod, fn, files, outs = ENTRIES[cell.config["entry"]]
    return getattr(importlib.import_module(mod), fn), files, outs


def compress_files(cell: Cell, work: str, inp, k: int, device: str,
                   control: Optional[str], dbg, span: Callable = None
                   ) -> Tuple[str, List[str], float]:
    """Job k's files written and compressed: (archive, inputs, seconds
    inside the call)."""
    span = span or (lambda name: contextlib.nullcontext())
    fn, files, _ = _entry(cell)
    paths = [os.path.join(work, f"input{k}_{f}.fastq") for f in range(files)]
    arc = os.path.join(work, f"job{k}.fqz")
    inp.write(paths, k)
    params = make_params(cell, control)
    _sync(device)
    t0 = time.perf_counter()
    with span("fqbench.compress"):
        fn(params, *paths, arc, dbg=dbg, device=device)
        _sync(device)
    return arc, paths, time.perf_counter() - t0


def _remove_job_files(work: str, k: int) -> None:
    for name in os.listdir(work):
        if name.startswith((f"input{k}_", f"job{k}.")):
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(work, name))


def run_job(cell: Cell, work: str, inp, k: int, device: str,
            control: Optional[str] = None, span: Callable = None) -> Job:
    """Job ``k``: its input written (gen.RotatedInput), compressed, and
    decompressed into FIFOs; ``span(name)`` (a context manager) wraps
    each call when the job is traced.  A failure is kept in
    ``Job.error``, not raised."""
    from fastqueeze_tpu_torch.pipeline import driver
    from fastqueeze_tpu_torch.utils.metrics import DebugInfo
    span = span or (lambda name: contextlib.nullcontext())
    t_job = time.perf_counter()
    job = Job(index=k, input_bytes=inp.nbytes)
    prefix = os.path.join(work, "restored")
    dbg_c, dbg_d = DebugInfo(), DebugInfo()
    try:
        arc, _, job.compress_s = compress_files(
            cell, work, inp, k, device, control, dbg_c, span)
        job.archive_bytes = os.path.getsize(arc)
        job.archive_sha256 = _sha256(arc)
        sinks = []
        try:
            for f, suffix in enumerate(_entry(cell)[2]):
                sinks.append(FifoSink(prefix + suffix,
                                      inp.bases[f].size + (1 << 20)))
            t0 = time.perf_counter()
            with span("fqbench.decompress"):
                driver.decompress(arc, prefix, dbg=dbg_d, force=True,
                                  device=device)
                _sync(device)
            job.decompress_s = time.perf_counter() - t0
        finally:
            job.restored = [sink.finish() for sink in sinks]
        job.overflow = sum(sink.overflow for sink in sinks)
        job.restored_bytes = sum(map(len, job.restored)) + job.overflow
    except Exception as e:          # the job failed: kept, reported
        import traceback
        traceback.print_exc(file=sys.stderr)
        job.error = f"{type(e).__name__}: {e}"
    finally:
        _remove_job_files(work, k)
    job.dbg = {"compress": dict(dbg_c.vals), "decompress": dict(dbg_d.vals)}
    job.wall_s = time.perf_counter() - t_job
    print(f"fqbench: job {k}: compress {job.compress_s:.3f} s, decompress "
          f"{job.decompress_s:.3f} s, wall {job.wall_s:.3f} s, archive "
          f"{job.archive_bytes} B, train_s "
          f"{job.dbg['compress'].get('train_s', 0.0):.3f}"
          + (f"; failed: {job.error}" if job.error else ""), file=sys.stderr)
    return job


def run_window(cell: Cell, work: str, inp, device: str, seconds: float,
               prev_s: float, control: Optional[str] = None) -> List[Job]:
    """Jobs 1, 2, ... back to back, one client: a job that the previous
    job's wall time (``prev_s``: the set-up job's, for the first) says
    would end after ``seconds`` is not started; the first always runs."""
    jobs: List[Job] = []
    deadline = time.perf_counter() + seconds
    while not jobs or time.perf_counter() + prev_s <= deadline:
        job = run_job(cell, work, inp, 1 + len(jobs), device, control)
        jobs.append(job)
        if job.error:
            break
        prev_s = job.wall_s
    return jobs


# --- the check -------------------------------------------------------------

def recompress_unlike(cell: Cell, work: str, inp, job: Job, device: str,
                      control: Optional[str] = None) -> int:
    """The guarantee that the same input and flags give the same archive:
    ``job``'s files compressed once more, after the window and outside
    every timed call; 1 where the archive's SHA-256 differs from the
    job's (or the call fails), else 0."""
    from fastqueeze_tpu_torch.utils.metrics import DebugInfo
    try:
        arc, _, _ = compress_files(cell, work, inp, job.index, device,
                                   control, DebugInfo())
        return int(_sha256(arc) != job.archive_sha256)
    except Exception:
        import traceback
        traceback.print_exc(file=sys.stderr)
        return 1
    finally:
        _remove_job_files(work, job.index)


def check_jobs(cell: Cell, jobs: List[Job], inp,
               unlike: int) -> Dict[str, Dict[str, float]]:
    """Each number compared, with its limit: the mix's reference's
    comparison of every job's restored files with the files that job
    compressed, the jobs that failed or restored nothing, and the
    archives that a second compress did not repeat (``unlike``)."""
    ref = _load_module(reference_path(cell.mix["reference"], cell.bench_dir),
                       "fqbench_reference_" + cell.mix["reference"])
    wrong = sum(ref.bytes_wrong(inp.expected(j.index, f),
                                np.frombuffer(got, np.uint8))
                for j in jobs if j.restored is not None
                for f, got in enumerate(j.restored))
    wrong += sum(j.overflow for j in jobs)
    failed = sum(1 for j in jobs if j.error or j.restored is None)
    return {"bytes_wrong": {"value": wrong, "limit": 0},
            "jobs_failed": {"value": failed, "limit": 0},
            "archives_unlike": {"value": unlike, "limit": 0}}


def end_to_end(jobs: List[Job], setup_s: float) -> Dict[str, float]:
    done = [j for j in jobs if not j.error]
    out = {"setup_s": setup_s}
    if done:
        c_s = sum(j.compress_s for j in done)
        d_s = sum(j.decompress_s for j in done)
        inp = sum(j.input_bytes for j in done)
        out.update(compress_MBps=inp / 1e6 / c_s,
                   decompress_MBps=sum(j.restored_bytes for j in done)
                   / 1e6 / d_s,
                   ratio=inp / sum(j.archive_bytes for j in done))
    return out


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


# --- the run ---------------------------------------------------------------

def make_input(cell: Cell, seed: int):
    """The cell's FASTQ files from ``seed``, as gen.RotatedInput."""
    from fqbench import gen
    return gen.RotatedInput(gen.make_files(
        seed, int(cell.mix["reads_per_file"]), cell.config["reads"]))


def start_input(cell: Cell, seed: int):
    """make_input in a thread of its own, started now (it overlaps the
    process's CUDA start); returns a future, read by run_cell."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(make_input, cell, seed)
    pool.shutdown(wait=False)
    return fut


def process_age_s() -> Optional[float]:
    """Seconds since this process started (its start time in
    /proc/self/stat against the boot clock); None where unreadable."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return None


def set_caches(root: str = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its kernels into its own _build/ and native/; these are
    for any library that compiles at run time)."""
    base = os.path.join(root, "fqbench", "_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))


def build(device: str) -> None:
    """The port's kernels and the native host library, built once into
    the checkout (fastqueeze_tpu_torch/_build/, native/)."""
    from fastqueeze_tpu_torch.io import native
    if native.get_lib() is None:
        raise RuntimeError("native host library unavailable (make -C native)")
    if device.startswith("cuda"):
        from fastqueeze_tpu_torch.ops import kernels
        kernels.build()


def device_info(device: str, chips: int) -> Dict:
    import torch
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: Optional[str] = None,
             t_start: Optional[float] = None, inp_future=None) -> Dict:
    """Set-up (build, input, one warm-up job), then the window (or, with
    ``trace``, one traced job), then the check.  Returns the result line
    as a dict; ``correct`` false where any check fails.  ``inp_future``:
    the input, started by start_input.  ``setup_parts`` splits
    ``setup_s``: the kernel build (long only in a checkout's first run)
    is recorded apart from the rest."""
    t_start = time.perf_counter() if t_start is None else t_start
    work = tempfile.mkdtemp(prefix="fqbench-")
    try:
        t0 = time.perf_counter()
        build(device)
        t1 = time.perf_counter()
        inp = (inp_future.result() if inp_future is not None
               else make_input(cell, seed))
        t2 = time.perf_counter()
        warm = run_job(cell, work, inp, 0, device, control)
        if warm.error:
            raise RuntimeError(f"the set-up job failed: {warm.error}")
        warm.restored = None
        if device.startswith("cuda"):
            import torch
            for d in range(cell.chips):
                torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.perf_counter() - t_start
        parts = {"start_s": t0 - t_start, "build_s": t1 - t0,
                 "input_s": t2 - t1, "warmup_s": warm.wall_s}
        print("fqbench: set-up " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()), file=sys.stderr)
        if trace:
            from fqbench import tracing
            jobs, traced = tracing.traced_job(cell, work, inp, device,
                                              control)
        else:
            jobs = run_window(cell, work, inp, device, seconds, warm.wall_s,
                              control)
        dev = device_info(device, cell.chips)
        last = [j for j in jobs if not j.error]
        unlike = (recompress_unlike(cell, work, inp, last[-1], device,
                                    control) if last else 0)
        checks = check_jobs(cell, jobs, inp, unlike)
        for j in jobs:
            j.restored = None
        result = {"correct": all(c["value"] <= c["limit"]
                                 for c in checks.values()),
                  "attempted": len(jobs),
                  "failed": sum(1 for j in jobs if j.error)}
        if trace:
            metrics, breakdown = tracing.per_layer(cell, jobs[0], traced)
            if traced is not None:
                dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
            result.update(metrics=metrics, device=dev, breakdown=breakdown)
        else:
            vals = end_to_end(jobs, setup_s)
            result.update(metrics={
                m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end if m["name"] in vals}, device=dev)
        result["setup_parts"] = parts
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)
