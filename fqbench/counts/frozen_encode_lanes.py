"""K2 frozen_encode_lanes: a symbol grid against a frozen table -> the rANS
words, emit flags and final states.

Copied from chip_smoke.py's BOUNDS entry for this kernel at commit
754d661: each input byte read once and each output byte written once,
and the integer operations a coded symbol needs (30: context update,
table gather, rANS step and renormalisation). call holds the wrapper's
arguments and results as fqbench.tracing.TensorInfo (shape, bytes, small
tensors whole). Returns (bytes, operations)."""

OPS_PER_SYMBOL = 30


def count(call):
    syms, cgrid, packed = call.args[:3]
    words, emit, states = call.out
    nsym = cgrid.total()
    return (syms.nbytes + cgrid.nbytes + packed.nbytes + words.nbytes
            + emit.nbytes + states.nbytes, OPS_PER_SYMBOL * nsym)
