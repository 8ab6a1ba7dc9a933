"""Mean of the replica's request:admit spans (enqueue to the fan-out of the
first token), ms, over the window."""

from portbench import readers


def read(ctx):
    return readers.mean_span_ms(ctx, "request:admit")
