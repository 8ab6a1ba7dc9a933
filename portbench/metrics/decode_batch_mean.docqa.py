"""Mean batch of the window's decode spans: the slots a decode step served."""

from portbench import readers


def read(ctx):
    return readers.mean_arg(ctx, "decode", "batch")
