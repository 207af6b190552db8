"""T_LoC of the cell's program, compiled in set-up (the program's own
``t_loc``)."""


def read(ctx):
    return 1e3 * ctx.compile_s if ctx.compile_s > 0 else None
