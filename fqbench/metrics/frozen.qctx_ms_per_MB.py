"""frozen trainer (pipeline/frozen.py): the quality-context selection
(DebugInfo train.qctx_s: each candidate scheme's histograms and its table
priced by bz2-9) in ms a MB of input; nothing where the file takes the
adaptive coder.  Moves compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    if "train.qctx_s" not in d:
        return None
    return d["train.qctx_s"] * 1e3 / ctx.input_mb
