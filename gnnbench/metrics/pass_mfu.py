"""Model operations of the requests answered inside the window over the
window's seconds times the card's fp32 peak, in %."""


def read(ctx):
    if ctx.peaks is None or ctx.seconds <= 0:
        return None
    rate = ctx.completed * ctx.flops_per_request / ctx.seconds
    return 100.0 * rate / ctx.peaks["fp32_flop_s"]
