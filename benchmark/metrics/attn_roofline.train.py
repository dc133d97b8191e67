"""The attention ops' least time on the chip (``lib/flops.AttentionOp``:
per op, not per kernel) over the summed time of the attention kernels in
the window, as a share.  Nothing to read where no attention kernel ran."""


def read(ctx):
    spent = ctx.trace.family_kernel_s("attention")
    if spent <= 0.0:
        return None
    return 100.0 * sum(op.bound_s() for op in ctx.attention_ops) / spent
