"""The plain reference of a compress-then-decompress job.

The system is a lossless FASTQ compressor: the bytes a decompress call
restores from an archive are the bytes that were compressed into it.  So
the reference output of a job is the generated input itself, and the
comparison is exact.  Plain NumPy; it imports nothing of the program and
reads nothing the program made but the restored bytes it judges.

A reference module of a mix (``reference`` in mixes/<traffic>.json)
exposes ``bytes_wrong(original, restored)``: the original file that a job
compressed and the file it restored, both uint8.
"""

from __future__ import annotations

import numpy as np

# compared in pieces so that the comparison allocates little
_PIECE = 1 << 24


def bytes_wrong(original: np.ndarray, restored: np.ndarray) -> int:
    """Positions at which ``restored`` differs from ``original``, plus
    the bytes by which their lengths differ: 0 only for an exact copy."""
    n = min(original.size, restored.size)
    wrong = abs(int(original.size) - int(restored.size))
    for a in range(0, n, _PIECE):
        b = min(a + _PIECE, n)
        wrong += int(np.count_nonzero(original[a:b] != restored[a:b]))
    return wrong
