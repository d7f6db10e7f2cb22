"""driver (pipeline/driver.py): the decompress call's MD5s (DebugInfo
md5_s: each block's and the whole input's) in ms a MB restored.  Moves
decompress_MBps."""


def read(ctx):
    d = ctx.dbg["decompress"]
    if "md5_s" not in d or not ctx.restored_mb:
        return None
    return d["md5_s"] * 1e3 / ctx.restored_mb
