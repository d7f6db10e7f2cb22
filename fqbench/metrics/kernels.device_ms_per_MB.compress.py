"""kernels (ops/kernels.py, csrc/): device time of every kernel record
of the compress call (the port's kernels and PyTorch's) in ms a MB
of input.  Moves compress_MBps."""


def read(ctx):
    ph = ctx.phases["compress"]
    if not any(c == "kernel" for _, _, _, c in ph.records):
        return None
    return ph.ms_of("kernel") / ctx.input_mb
