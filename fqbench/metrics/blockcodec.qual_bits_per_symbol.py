"""block codec (pipeline/blockcodec.py): bits of the quality payloads a
quality symbol coded (DebugInfo sz_qual x 8 / raw_qual).  Moves ratio."""


def read(ctx):
    d = ctx.dbg["compress"]
    if not d.get("raw_qual"):
        return None
    return d["sz_qual"] * 8 / d["raw_qual"]
