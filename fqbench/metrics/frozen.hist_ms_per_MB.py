"""frozen trainer (pipeline/frozen.py): the training prefix's quality
vocabulary and its seq and quality histograms (DebugInfo train.hist_s,
the native train_prefix pass) in ms a MB of input; nothing where the
file takes the adaptive coder.  Moves compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    if "train.hist_s" not in d:
        return None
    return d["train.hist_s"] * 1e3 / ctx.input_mb
