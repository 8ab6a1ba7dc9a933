"""Model FLOPs of the traced slice over (device-busy seconds x the bf16 peak),
in %: it still moves when any kernel gets faster, though the fixed rate pins
the FLOPs."""

from portbench import readers


def read(ctx):
    return readers.peak_share(ctx, ctx.work.get("model_flops", 0.0),
                              ctx.busy_s)
