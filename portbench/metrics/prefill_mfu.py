"""Model FLOPs of the window's prefills over their device time x the bf16
peak, in %: each ``prefill`` span's work from its ``tokens`` and
``cached_tokens`` (``flops.prefill_flops``), its time its ``device_us``."""

from portbench import flops, readers


def read(ctx):
    work = us = 0.0
    for sp in readers.spans(ctx, "prefill"):
        a = sp.get("args") or {}
        if "device_us" not in a:
            continue
        work += flops.prefill_flops(ctx.sizes, a["tokens"],
                                    a["cached_tokens"])
        us += a["device_us"]
    return readers.peak_share(ctx, work, us / 1e6)
