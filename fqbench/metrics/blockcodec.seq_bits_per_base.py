"""block codec (pipeline/blockcodec.py): bits of the seq payloads a base
coded (DebugInfo sz_seq x 8 / raw_seq).  Moves ratio."""


def read(ctx):
    d = ctx.dbg["compress"]
    if not d.get("raw_seq"):
        return None
    return d["sz_seq"] * 8 / d["raw_seq"]
