"""Mean decode span (one batched decode step, up to its host sync), ms, over
the window (``decode_step_ms.chat``, ``.docqa``)."""

from portbench import readers


def read(ctx):
    return readers.mean_span_ms(ctx, "decode")
