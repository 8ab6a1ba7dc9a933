"""Kernels 1-3's share of their roofline in the traced slice's steps, in %: one
forward and one backward of causal attention (3x the forward's FLOPs; the
remat's second forward and the backward's recomputed scores are time, not
work), over the device time of the kernels this metric's data file names."""

from portbench import readers


def read(ctx):
    w = ctx.work
    return readers.roofline(ctx, w.get("attn_flops", 0.0),
                            w.get("attn_bytes", 0.0), ctx.data["kernels"])
