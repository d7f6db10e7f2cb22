"""pe (pipeline/pe.py): the compress call's pair work, file 2's records
read by file 1's count (DebugInfo pe.mate2_s) and the mates interleaved
for the trainer, the probe and each block pair (pe.interleave_s), in ms a
MB of input; nothing where the call has neither stage.  Moves
compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    if "pe.mate2_s" not in d and "pe.interleave_s" not in d:
        return None
    return ((d.get("pe.mate2_s", 0.0) + d.get("pe.interleave_s", 0.0))
            * 1e3 / ctx.input_mb)
