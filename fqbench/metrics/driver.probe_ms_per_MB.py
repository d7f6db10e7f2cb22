"""driver (pipeline/driver.py): the auto self-align probe on the first
block (DebugInfo probe_s, selfref.auto_self_align) in ms a MB of input.
Moves compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    if "probe_s" not in d:
        return None
    return d["probe_s"] * 1e3 / ctx.input_mb
