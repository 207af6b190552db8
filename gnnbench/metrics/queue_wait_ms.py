"""Mean queue wait the runtime reports for the window's requests
(``ServeLoop``: admission to the start of the batch's pass, host clock)."""


def read(ctx):
    w = [d.queue_wait for d in ctx.sent]
    return 1e3 * sum(w) / len(w) if w else None
