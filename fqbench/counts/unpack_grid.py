"""K15 unpack_grid: a packed (T, w) grid (and in modes 15 and 23 its
sidecar) -> the (T, L) symbol grid.

Copied from chip_smoke.py's BOUNDS entry for this kernel at commit
754d661: each input byte read once and each output byte written once,
and the integer operations a grid slot needs (3: shift, mask, store).
call holds the wrapper's arguments and results as
fqbench.tracing.TensorInfo (shape, bytes, small tensors whole). Returns
(bytes, operations)."""

OPS_PER_SLOT = 3


def count(call):
    packed = call.args[0]
    side = call.args[2] if len(call.args) > 2 else call.kwargs.get("side")
    grid = call.out
    return (packed.nbytes + grid.nbytes + (side.nbytes if side else 0),
            OPS_PER_SLOT * grid.numel)
