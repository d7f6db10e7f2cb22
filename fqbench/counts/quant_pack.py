"""K1 quant_pack: a count table -> its cumulative table and packed
start|end words.

Copied from chip_smoke.py's BOUNDS entry for this kernel at commit
754d661: each input byte read once and each output byte written once,
and the integer operations a table entry needs (4: the row scan, the
division, the pack). call holds the wrapper's arguments and results as
fqbench.tracing.TensorInfo (shape, bytes, small tensors whole). Returns
(bytes, operations)."""

OPS_PER_ENTRY = 4


def count(call):
    counts = call.args[0]
    cum, packed = call.out
    return (counts.nbytes + cum.nbytes + packed.nbytes,
            OPS_PER_ENTRY * counts.numel)
