"""frozen trainer (pipeline/frozen.py, through driver._train): the frozen
tables' training (DebugInfo train_s) in ms a MB of input; nothing where
the file takes the adaptive coder.  Moves compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    if "train_s" not in d:
        return None
    return d["train_s"] * 1e3 / ctx.input_mb
