"""pe (pipeline/pe.py): the decompress call's block pairs split back into
the two mates' records (DebugInfo pe.deinterleave_s) in ms a MB restored;
nothing where the call has no such stage.  Moves decompress_MBps."""


def read(ctx):
    d = ctx.dbg["decompress"]
    if "pe.deinterleave_s" not in d or not ctx.restored_mb:
        return None
    return d["pe.deinterleave_s"] * 1e3 / ctx.restored_mb
