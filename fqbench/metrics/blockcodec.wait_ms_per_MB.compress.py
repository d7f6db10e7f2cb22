"""block codec (pipeline/blockcodec.py): the compress call's wait for the
seq and quality streams (DebugInfo codec.wait_s: the device's sync, the
read-back and the host's tail of each stream) in ms a MB of input.
Moves compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    if "codec.wait_s" not in d:
        return None
    return d["codec.wait_s"] * 1e3 / ctx.input_mb
