"""Reductions the per-layer metric readers share.

Each reader in ``metrics/`` is a small module whose ``read(ctx)`` returns
its value, or None where it finds nothing to read (the harness then leaves
the metric out). ``ctx`` is ``harness.Context``: the window's and the
traced slice's flight-recorder spans, the slice's device activity
(``trace.Kernel`` rows), its length, the device's busy seconds (the union of
its kernels' intervals) and the slice's work, as its traffic driver
counts it.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional

from . import flops


def spans(ctx, name: str) -> List[dict]:
    return [sp for sp in ctx.spans if sp["name"] == name]


def mean_span_ms(ctx, name: str) -> Optional[float]:
    xs = [sp["dur_us"] / 1e3 for sp in spans(ctx, name)]
    return sum(xs) / len(xs) if xs else None


def mean_arg(ctx, name: str, arg: str) -> Optional[float]:
    xs = [(sp.get("args") or {}).get(arg) for sp in spans(ctx, name)]
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def hit_share(ctx) -> Optional[float]:
    """Prompt tokens served from the prefix cache, in % of all prefilled
    prompt tokens."""
    rows = [sp.get("args") or {} for sp in spans(ctx, "prefill")]
    total = sum(a.get("tokens", 0) for a in rows)
    if not total:
        return None
    return 100.0 * sum(a.get("cached_tokens", 0) for a in rows) / total


def idle_share(ctx) -> Optional[float]:
    if not ctx.kernels or ctx.slice_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.slice_s)


def peak_share(ctx, model_flops: float, seconds: float) -> Optional[float]:
    """Model FLOPs over (seconds x chips x the chip's bf16 peak), in %."""
    peak = ctx.peak("bf16_flops")
    if not model_flops or not seconds or peak is None:
        return None
    return 100.0 * model_flops / (seconds * ctx.chips * peak)


def matching(ctx, patterns: Iterable[str]):
    rx = [re.compile(p) for p in patterns]
    return [k for k in ctx.kernels if any(r.search(k.name) for r in rx)]


def roofline(ctx, work_flops: float, work_bytes: float,
             patterns) -> Optional[float]:
    """The least time the work needs on this chip (the larger of FLOPs
    over the bf16 peak and bytes over HBM bandwidth), in % of the device
    time of the kernels ``patterns`` match."""
    ks = matching(ctx, patterns)
    t = sum(k.dur_us for k in ks) / 1e6
    peak, bw = ctx.peak("bf16_flops"), ctx.peak("hbm_bytes_per_s")
    if not ks or t <= 0 or not work_flops or peak is None:
        return None
    return 100.0 * max(work_flops / peak, work_bytes / bw) / t


def class_share(ctx, classes: dict, share_of: Iterable[str]
                ) -> Optional[float]:
    """Device time of the kernels in the classes ``share_of``, in % of all
    device time; ``classes`` maps a class to name patterns, the first
    class that matches taking a kernel."""
    rx = [(c, [re.compile(p) for p in ps]) for c, ps in classes.items()]
    total = part = 0.0
    want = set(share_of)
    for k in ctx.kernels:
        total += k.dur_us
        for c, ps in rx:
            if any(p.search(k.name) for p in ps):
                if c in want:
                    part += k.dur_us
                break
    return 100.0 * part / total if total else None


def full_prefill_work(ctx):
    """(FLOPs, bytes) of kernel 1 for the slice's full prefills, at their
    real prompt lengths."""
    fl = by = 0.0
    for n in ctx.work.get("full_prefills", ()):
        f, b = flops.flash_forward_work(ctx.sizes, 1, n)
        fl, by = fl + f, by + b
    return fl, by
