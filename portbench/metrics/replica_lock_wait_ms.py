"""Mean ``lock_wait_us`` of the window's ``request:admit`` spans, ms: how
long a request waited for the serving replica's lock (the engine step in
flight) before it was enqueued."""

from portbench import readers


def read(ctx):
    x = readers.mean_arg(ctx, "request:admit", "lock_wait_us")
    return x / 1e3 if x is not None else None
