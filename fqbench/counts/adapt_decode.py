"""K6 adapt_decode: an adaptive stream's words -> its (T, L) symbol grid,
the table updated as it goes.

Copied from chip_smoke.py's BOUNDS entry for this kernel at commit
754d661: each input byte read once and each output byte written once,
and the integer operations a decoded symbol needs (40: context, the
frequency search, the rANS step, renormalisation and the count update);
the words are counted as half the padded buffer (see frozen_decode).
call holds the wrapper's arguments and results as
fqbench.tracing.TensorInfo (shape, bytes, small tensors whole). Returns
(bytes, operations)."""

OPS_PER_SYMBOL = 40


def count(call):
    states, words, cgrid = call.args[:3]
    return (states.nbytes + cgrid.nbytes + call.out.nbytes
            + 2 * (words.numel // 2), OPS_PER_SYMBOL * cgrid.total())
