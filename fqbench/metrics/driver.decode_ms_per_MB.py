"""driver (pipeline/driver.py): the decompress call's decode loop
(DebugInfo decode_s: blocks decoded, assembled, MD5-checked and written)
in ms a MB restored.  Moves decompress_MBps."""


def read(ctx):
    d = ctx.dbg["decompress"]
    if "decode_s" not in d or not ctx.restored_mb:
        return None
    return d["decode_s"] * 1e3 / ctx.restored_mb
