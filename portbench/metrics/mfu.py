"""Model FLOPs of the traced slice over (its length x chips x the bf16 peak),
in % (``mfu.docqa``, ``mfu.train``)."""

from portbench import readers


def read(ctx):
    return readers.peak_share(ctx, ctx.work.get("model_flops", 0.0),
                              ctx.slice_s)
