"""Mean latency, submit to recorded response, over every request sent in
the window (the clients' own host clock)."""


def read(ctx):
    lat = [d.done - d.sent for d in ctx.sent]
    return 1e3 * sum(lat) / len(lat) if lat else None
