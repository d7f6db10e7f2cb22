"""K4 frozen_decode: a frozen stream's words -> its (T, L) symbol grid.

Copied from chip_smoke.py's BOUNDS entry for this kernel at commit
754d661: each input byte read once and each output byte written once,
and the integer operations a decoded symbol needs (25: context, the
frequency search, the rANS step and renormalisation); the words are
counted as half the padded buffer, which the decoder pads to the power
of two at or above the stream's words and 8 more, so no more than the
stream holds. call holds the wrapper's arguments and results as
fqbench.tracing.TensorInfo (shape, bytes, small tensors whole). Returns
(bytes, operations)."""

OPS_PER_SYMBOL = 25


def count(call):
    states, words, cgrid, _T, cum = call.args[:5]
    out = call.out
    return (states.nbytes + cgrid.nbytes + cum.nbytes + out.nbytes
            + 2 * (words.numel // 2), OPS_PER_SYMBOL * cgrid.total())
