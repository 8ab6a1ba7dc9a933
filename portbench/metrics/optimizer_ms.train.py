"""Median device time of the train step's ``train:optimizer`` span (the
global norm with its host sync, the AdamW update), ms, over the window's
steps."""

from portbench import program_spans


def read(ctx):
    return program_spans.window_steps_ms("train:optimizer")
