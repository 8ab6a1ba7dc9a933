"""Prompt tokens served from the prefix cache over all prompt tokens of the
window's prefill spans, in %."""

from portbench import readers


def read(ctx):
    return readers.hit_share(ctx)
