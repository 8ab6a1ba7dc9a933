"""Mean ``hold_us`` of the window's ``request:admit`` spans, ms: how long a
request's first token, once on the host, waited for the replica to hand it
to its stream (the rest of its engine step)."""

from portbench import readers


def read(ctx):
    x = readers.mean_arg(ctx, "request:admit", "hold_us")
    return x / 1e3 if x is not None else None
