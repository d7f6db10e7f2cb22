"""K17 pack15: a decoded 6-bit grid -> nibbles of its top 15 symbols and a
sidecar of the rest.

Copied from chip_smoke.py's BOUNDS entry for this kernel at commit
754d661: each input byte read once and each output byte written once,
and the integer operations a grid slot needs (8: the histogram, the rank
lookup, the nibble pack and the exception test). call holds the
wrapper's arguments and results as fqbench.tracing.TensorInfo (shape,
bytes, small tensors whole). Returns (bytes, operations)."""

OPS_PER_SLOT = 8


def count(call):
    syms, cgrid = call.args[:2]
    nib, _side, n_exc = call.out
    cap = syms.numel // 4
    return (syms.nbytes + cgrid.nbytes + nib.nbytes + n_exc.nbytes + 16
            + min(n_exc.total(), cap), OPS_PER_SLOT * syms.numel)
