"""engine (ops/engine.py): device time of the decompress call's copies between
host and card (the trace's gpu_memcpy records) in ms a MB restored.
Moves decompress_MBps."""


def read(ctx):
    ph = ctx.phases["decompress"]
    if not any(c == "gpu_memcpy" for _, _, _, c in ph.records):
        return None
    return ph.ms_of("gpu_memcpy") / ctx.restored_mb
