"""driver (pipeline/driver.py): the frozen tables packed into the archive's
model (DebugInfo serialize_s, frozen.serialize_frozen) in ms a MB of
input; nothing where the file takes the adaptive coder.  Moves
compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    if "serialize_s" not in d:
        return None
    return d["serialize_s"] * 1e3 / ctx.input_mb
