"""Process start to the first timed request: graph, weights, features,
compile, warm passes and captures."""


def read(ctx):
    return ctx.setup_s
