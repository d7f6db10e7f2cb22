"""device (H100): the share of the decompress call's time in which no kernel,
copy or memset record was on the card, in %.  Moves decompress_MBps."""


def read(ctx):
    ph = ctx.phases["decompress"]
    if not ph.window_ms:
        return None
    return 100.0 * (1.0 - ph.busy_ms / ph.window_ms)
