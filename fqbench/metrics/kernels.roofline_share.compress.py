"""kernels (ops/kernels.py, csrc/): the compress call's port kernels' bounds
over their device time, in %.  A wrapper call's device time is that of
the kernel records its launches made; its bound is the larger of the
bytes and the integer operations that counts/<kernel>.py gives for its
inputs over the card's peaks (peaks.json).  A kernel with no counts file
adds its time and no bound.  Moves compress_MBps."""


def read(ctx):
    rows = ctx.phases["compress"].launches
    dev = sum(r.device_us for r in rows)
    if not rows or not dev:
        return None
    return 100.0 * sum(r.bound_us or 0.0 for r in rows) / dev
