"""driver (pipeline/driver.py): the compress call's parse, dispatch and
encode stages (DebugInfo parse_s + dispatch_s + encode_s) in ms a MB of
input.  Moves compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    keys = ("parse_s", "dispatch_s", "encode_s")
    if not any(k in d for k in keys):
        return None
    return sum(d.get(k, 0.0) for k in keys) * 1e3 / ctx.input_mb
