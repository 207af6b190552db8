"""Share of the traced stretch with no kernel, copy or set running on the
card, in % (``torch.profiler`` device activity)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.events == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
