"""driver (pipeline/driver.py): the share of the frozen tables' packing
that the compress call does not wait for, in %: 100 x (1 - DebugInfo
serialize_s / pack_s).  pack_s is the packing thread's seconds
(frozen._Packing: the seq table's bucket choice and pack, the quality
table's pack), serialize_s the call's wait for them before the archive
is written.  Nothing where the table has no pack_s: the adaptive coder,
a program that packs on the calling thread.  Moves compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    if not d.get("pack_s") or "serialize_s" not in d:
        return None
    return 100.0 * (1.0 - d["serialize_s"] / d["pack_s"])
