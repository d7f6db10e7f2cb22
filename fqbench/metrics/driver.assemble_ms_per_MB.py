"""driver (pipeline/driver.py): the decoded blocks assembled into FASTQ
text (DebugInfo assemble_s, io.fastq.assemble_block) in ms a MB
restored.  Moves decompress_MBps."""


def read(ctx):
    d = ctx.dbg["decompress"]
    if "assemble_s" not in d or not ctx.restored_mb:
        return None
    return d["assemble_s"] * 1e3 / ctx.restored_mb
