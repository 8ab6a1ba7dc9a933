"""The port's copies of the exceptions it raises, from ray_tpu/exceptions.py.

The port imports nothing of ``ray_tpu``, so it keeps its own classes of the
same names. ``DeadlineExceededError``, ``OverloadedError`` and
``StreamBrokenError`` come with the serving layer.
"""

from __future__ import annotations


class RayError(Exception):
    """Base class of the port's errors."""


class KVGatherError(RayError):
    """A KV part of a paged request could not be gathered.

    Raised by the engine's streamed-attention path when ``kv_fetch`` (or a
    ``kv_prefetch`` future) fails for a part, or returns something that is
    not a ``{"k", "v", "len"}`` dict. The underlying error rides
    ``__cause__``. The request it belongs to retires with finish_reason
    "error" and never emits a wrong token; its pages return to the pool at
    once, and the other requests of the batch go on."""
