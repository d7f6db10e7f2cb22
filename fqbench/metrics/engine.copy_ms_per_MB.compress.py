"""engine (ops/engine.py): device time of the compress call's copies between
host and card (the trace's gpu_memcpy records) in ms a MB of input.
Moves compress_MBps."""


def read(ctx):
    ph = ctx.phases["compress"]
    if not any(c == "gpu_memcpy" for _, _, _, c in ph.records):
        return None
    return ph.ms_of("gpu_memcpy") / ctx.input_mb
