"""Leveled colored logger (parity: reference seqPrintf @0x40cae0,
SURVEY.md C19 — red=error, yellow=warn, blue=info)."""

from __future__ import annotations

import os
import sys
import time

_LEVELS = {"error": 0, "warn": 1, "info": 2, "debug": 3}
_COLORS = {"error": "\x1b[31m", "warn": "\x1b[33m", "info": "\x1b[34m",
           "debug": ""}
_RESET = "\x1b[0m"

LEVEL = _LEVELS.get(os.environ.get("FQZ_LOG", "info"), 2)
_TTY = sys.stderr.isatty()


def _emit(level: str, msg: str) -> None:
    if _LEVELS[level] > LEVEL:
        return
    stamp = time.strftime("%H:%M:%S")
    if _TTY:
        sys.stderr.write(f"{_COLORS[level]}[{stamp} {level}]{_RESET} {msg}\n")
    else:
        sys.stderr.write(f"[{stamp} {level}] {msg}\n")


def error(msg: str) -> None:
    _emit("error", msg)


def warn(msg: str) -> None:
    _emit("warn", msg)


def info(msg: str) -> None:
    _emit("info", msg)


def debug(msg: str) -> None:
    _emit("debug", msg)
