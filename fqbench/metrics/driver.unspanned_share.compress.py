"""driver (pipeline/driver.py): the share of the compress call's window
(the traced job's fqbench.compress range) that no stage of the program
accounts for, in %: the window less DebugInfo spanned_s, the seconds
under the program's outermost stage spans (fq.* ranges) on the calling
thread.  Moves compress_MBps."""


def read(ctx):
    d = ctx.dbg["compress"]
    window_s = ctx.phases["compress"].window_ms / 1e3
    if "spanned_s" not in d or not window_s:
        return None
    return 100.0 * (1.0 - d["spanned_s"] / window_s)
