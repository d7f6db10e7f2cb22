"""pe (pipeline/pe.py): the share of the PE decompress call's window (the
traced job's fqbench.decompress range) that no stage of the program
accounts for, in %: the window less DebugInfo spanned_s, the seconds
under the program's outermost stage spans (fq.* ranges) on the calling
thread.  Moves decompress_MBps."""


def read(ctx):
    d = ctx.dbg["decompress"]
    window_s = ctx.phases["decompress"].window_ms / 1e3
    if "spanned_s" not in d or not window_s:
        return None
    return 100.0 * (1.0 - d["spanned_s"] / window_s)
