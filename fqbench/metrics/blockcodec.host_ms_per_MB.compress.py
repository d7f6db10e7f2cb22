"""block codec (pipeline/blockcodec.py): the compress call's host stages of
the block codec (DebugInfo codec.dedup_s, codec.vocab_s, codec.ids_s,
codec.plus_s and codec.small_s: duplicate masks, symbol preparation, IDs,
plus lines, lengths, dup and degenerate streams) in ms a MB of input.
Moves compress_MBps."""

KEYS = ("codec.dedup_s", "codec.vocab_s", "codec.ids_s", "codec.plus_s",
        "codec.small_s")


def read(ctx):
    d = ctx.dbg["compress"]
    if not any(k in d for k in KEYS):
        return None
    return sum(d.get(k, 0.0) for k in KEYS) * 1e3 / ctx.input_mb
