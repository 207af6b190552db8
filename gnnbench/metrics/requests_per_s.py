"""Requests answered inside the window over the window's seconds."""


def read(ctx):
    return ctx.completed / ctx.seconds if ctx.seconds > 0 else None
