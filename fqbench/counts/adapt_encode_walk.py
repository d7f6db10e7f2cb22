"""K5 adapt_encode_walk: the adaptive table walk over a symbol grid -> each
slot's start and frequency.

Copied from chip_smoke.py's BOUNDS entry for this kernel at commit
754d661: each input byte read once and each output byte written once,
and the integer operations a coded symbol needs (30: context, table
gather, the row quantization and the count update). call holds the
wrapper's arguments and results as fqbench.tracing.TensorInfo (shape,
bytes, small tensors whole). Returns (bytes, operations)."""

OPS_PER_SYMBOL = 30


def count(call):
    syms, cgrid = call.args[:2]
    return (syms.nbytes + cgrid.nbytes + call.out.nbytes,
            OPS_PER_SYMBOL * cgrid.total())
