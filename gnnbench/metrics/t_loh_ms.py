"""Mean T_LoH of the window's responses: the engine's host clock around
a pass that ends in its stream's synchronise."""


def read(ctx):
    t = [d.t_loh for d in ctx.sent]
    return 1e3 * sum(t) / len(t) if t else None
