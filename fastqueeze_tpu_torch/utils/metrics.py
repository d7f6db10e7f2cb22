"""Per-run metrics accumulation (parity: reference DebugInfo, SURVEY.md C18
— per-stage timers, per-stream sizes, mapping histograms, printed as tables
after each run via printEncodeDebugInfo @0x41a930)."""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Dict


class DebugInfo:
    def __init__(self):
        self.vals: Dict[str, float] = defaultdict(float)

    def add(self, key: str, v: float) -> None:
        self.vals[key] += v

    def set(self, key: str, v: float) -> None:
        self.vals[key] = v

    def table(self) -> str:
        if not self.vals:
            return "(no metrics)"
        w = max(len(k) for k in self.vals)
        lines = [f"  {k.ljust(w)}  {v:,.3f}" for k, v in sorted(self.vals.items())]
        return "\n".join(lines)

    def print(self, title: str = "metrics") -> None:
        sys.stderr.write(f"--- {title} ---\n{self.table()}\n")
