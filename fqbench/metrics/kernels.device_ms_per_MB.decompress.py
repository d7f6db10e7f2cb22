"""kernels (ops/kernels.py, csrc/): device time of every kernel record
of the decompress call (the port's kernels and PyTorch's) in ms a MB
restored.  Moves decompress_MBps."""


def read(ctx):
    ph = ctx.phases["decompress"]
    if not any(c == "kernel" for _, _, _, c in ph.records):
        return None
    return ph.ms_of("kernel") / ctx.restored_mb
