"""Median device time of the train step's ``train:grad`` span (the forward
and the backward), ms, over the window's steps."""

from portbench import program_spans


def read(ctx):
    return program_spans.window_steps_ms("train:grad")
