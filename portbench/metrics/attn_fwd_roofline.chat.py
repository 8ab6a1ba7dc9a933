"""Kernel 1's share of its roofline in the traced slice, in %: the least time
the slice's full prefills need in attention, counted from their real prompt
lengths (causal pairs, not the padded buckets), over the device time of the
kernels this metric's data file names."""

from portbench import readers


def read(ctx):
    fl, by = readers.full_prefill_work(ctx)
    return readers.roofline(ctx, fl, by, ctx.data["kernels"])
