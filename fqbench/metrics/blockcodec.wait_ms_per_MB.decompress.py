"""block codec (pipeline/blockcodec.py): the decompress call's wait for the
seq and quality streams (DebugInfo codec.wait_s: the device's decode, its
read-back and the host's tail) in ms a MB restored.  Moves
decompress_MBps."""


def read(ctx):
    d = ctx.dbg["decompress"]
    if "codec.wait_s" not in d or not ctx.restored_mb:
        return None
    return d["codec.wait_s"] * 1e3 / ctx.restored_mb
