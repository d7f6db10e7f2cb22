"""K7 rans_encode_sf: the reverse rANS chain over starts and frequencies ->
words, emit flags and final states.

Copied from chip_smoke.py's BOUNDS entry for this kernel at commit
754d661: each input byte read once and each output byte written once,
and the integer operations a coded symbol needs (20: the rANS step and
renormalisation). call holds the wrapper's arguments and results as
fqbench.tracing.TensorInfo (shape, bytes, small tensors whole). Returns
(bytes, operations)."""

OPS_PER_SYMBOL = 20


def count(call):
    sf, cgrid = call.args[:2]
    return (sf.nbytes + cgrid.nbytes + sum(t.nbytes for t in call.out),
            OPS_PER_SYMBOL * cgrid.total())
