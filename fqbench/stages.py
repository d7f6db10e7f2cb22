"""The program's stage ranges in the traced job's Chrome trace.

While torch.profiler records, each stage span of the port
(``fastqueeze_tpu_torch/utils/metrics.py``) is a ``user_annotation``
range ``fq.<stage>`` on the thread that ran it.  From those ranges and the
device records this module gives, for each call (the harness's
``fqbench.compress`` / ``fqbench.decompress`` range):

- :func:`unspanned_share`: the share of the call's window under no
  ``fq.*`` range on the calling thread;
- :func:`idle_by_stage`: the card's idle time within the call, each
  moment given to the innermost ``fq.*`` range open on the calling thread
  then (``unspanned`` where none is).

``tracing.py`` does not call them yet: the breakdown's ``idle_by_stage``
key is one line there (see PERF.md, Open questions).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from fqbench.tracing import DEVICE_CATS, PHASES, SPAN, busy_ms

PREFIX = "fq."
UNSPANNED = "unspanned"


def _calls(xs: list) -> Dict[str, dict]:
    names = {SPAN.format(p): p for p in PHASES}
    return {names[e["name"]]: e for e in xs
            if e.get("cat") == "user_annotation" and e.get("name") in names}


def stage_ranges(evs: list, call: dict) -> List[Tuple[float, float, str]]:
    """(start, end, stage) of the fq.* ranges on ``call``'s thread that
    overlap it, in us, clipped to it."""
    lo, hi = call["ts"], call["ts"] + call["dur"]
    key = (call.get("pid"), call.get("tid"))
    return [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi),
             e["name"][len(PREFIX):]) for e in evs
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIX)
            and (e.get("pid"), e.get("tid")) == key
            and e["ts"] < hi and e["ts"] + e["dur"] > lo]


def unspanned_share(evs: list) -> Dict[str, float]:
    """{phase: % of the call's window under no fq.* range on its
    thread}."""
    out = {}
    for p, call in _calls([e for e in evs if e.get("ph") == "X"]).items():
        lo, hi = call["ts"], call["ts"] + call["dur"]
        rs = stage_ranges(evs, call)
        if hi > lo:
            out[p] = 100.0 * (1.0 - busy_ms([(a, b) for a, b, _ in rs],
                                            lo, hi) * 1e3 / (hi - lo))
    return out


def _idle(dev: List[Tuple[float, float]], lo: float, hi: float):
    """The intervals of [lo, hi) that no device record covers."""
    end = lo
    for a, b in sorted(dev):
        if b <= lo or a >= hi:
            continue
        if a > end:
            yield end, a
        end = max(end, b)
    if hi > end:
        yield end, hi


def idle_by_stage(evs: list) -> Dict[str, Dict[str, float]]:
    """{phase: {stage: seconds}}: each idle moment of the card within the
    call, given to the innermost fq.* range open on the calling thread
    (the open range that started last; ranges on one thread nest), or to
    ``unspanned``.  The seconds of a call add up to its idle time."""
    xs = [e for e in evs if e.get("ph") == "X"]
    dev = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in xs
           if e.get("cat") in DEVICE_CATS]
    out = {}
    for p, call in _calls(xs).items():
        rs = stage_ranges(xs, call)
        sums: Dict[str, float] = {}
        for a, b in _idle(dev, call["ts"], call["ts"] + call["dur"]):
            inside = [r for r in rs if r[0] < b and r[1] > a]
            cuts = sorted({a, b} | {x for r in inside for x in r[:2]
                                    if a < x < b})
            for s, t in zip(cuts, cuts[1:]):
                open_ = [r for r in inside if r[0] <= s and t <= r[1]]
                name = (max(open_, key=lambda r: (r[0], -r[1]))[2]
                        if open_ else UNSPANNED)
                sums[name] = sums.get(name, 0.0) + (t - s) / 1e6
        out[p] = sums
    return out


def top_idle(by_phase: Dict[str, Dict[str, float]], n: int = 10) -> list:
    """The ``n`` largest as ["<phase> call, in <stage>", seconds]."""
    rows = [[f"{p} call, in {name}", s] for p, sums in by_phase.items()
            for name, s in sums.items()]
    return sorted(rows, key=lambda r: -r[1])[:n]
