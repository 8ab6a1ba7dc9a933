"""Device time of the elementwise kernel classes over all device time in the
traced slice, in %; the classes are this metric's data file."""

from portbench import readers


def read(ctx):
    return readers.class_share(ctx, ctx.data["classes"], ctx.data["share_of"])
