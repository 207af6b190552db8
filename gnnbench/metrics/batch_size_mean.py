"""Mean requests a batch the runtime dispatched in the window."""


def read(ctx):
    s = ctx.batch_sizes
    return sum(s) / len(s) if s else None
