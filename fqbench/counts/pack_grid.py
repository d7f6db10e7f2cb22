"""K16 pack_grid: a (T, L) symbol grid -> its packed (T, w) form.

Copied from chip_smoke.py's BOUNDS entry for this kernel at commit
754d661: each input byte read once and each output byte written once,
and the integer operations a grid slot needs (3: shift, mask, or). call
holds the wrapper's arguments and results as fqbench.tracing.TensorInfo
(shape, bytes, small tensors whole). Returns (bytes, operations)."""

OPS_PER_SLOT = 3


def count(call):
    grid = call.args[0]
    return grid.nbytes + call.out.nbytes, OPS_PER_SLOT * grid.numel
