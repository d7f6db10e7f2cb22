"""block codec (pipeline/blockcodec.py): the decompress call's host stages
of the block codec (DebugInfo codec.host_s: lengths, degenerate, dup, ID
and plus streams, the bases and qualities put in place) in ms a MB
restored.  Moves decompress_MBps."""


def read(ctx):
    d = ctx.dbg["decompress"]
    if "codec.host_s" not in d or not ctx.restored_mb:
        return None
    return d["codec.host_s"] * 1e3 / ctx.restored_mb
