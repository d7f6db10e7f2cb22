"""pe (pipeline/pe.py, on driver.compress_blocks): the PE compress call's
wait for the frozen tables' packing thread just before the archive is
written (DebugInfo serialize_s) in ms a MB of input; nothing where the
call has no such stage (a call that joins the pack inside its training
records none).  Moves compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    if "serialize_s" not in d:
        return None
    return d["serialize_s"] * 1e3 / ctx.input_mb
