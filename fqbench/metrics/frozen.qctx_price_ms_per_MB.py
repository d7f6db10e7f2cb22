"""frozen trainer (pipeline/frozen.py): the bz2-9 pricing of the
quality-context candidates' tables (DebugInfo train.qctx.price_s, inside
train.qctx: the host's part of the selection once the card scores the
candidates) in ms a MB of input; nothing where the file takes the
adaptive coder, or where the program has no such span.  Moves
compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    if "train.qctx.price_s" not in d:
        return None
    return d["train.qctx.price_s"] * 1e3 / ctx.input_mb
