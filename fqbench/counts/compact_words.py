"""K3 compact_words: the emitted words of a (T, L) grid as one dense run.

Copied from chip_smoke.py's BOUNDS entry for this kernel at commit
754d661: each input byte read once and each output byte written once,
and the integer operations a grid slot needs (2: the flag test and the
scan). call holds the wrapper's arguments and results as
fqbench.tracing.TensorInfo (shape, bytes, small tensors whole). Returns
(bytes, operations)."""

OPS_PER_SLOT = 2


def count(call):
    words, emit = call.args[:2]
    n = call.out[1].total()
    return words.nbytes + emit.nbytes + 2 * n + 4, OPS_PER_SLOT * words.numel
