"""The port's copies of the exceptions it raises, from ray_tpu/exceptions.py.

The port imports nothing of ``ray_tpu``, so it keeps its own classes of the
same names, messages and attributes. The reference's runtime-only errors
(tasks, actors, objects, nodes) are not copied.
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


class DeadlineExceededError(RayError):
    """An end-to-end deadline expired before the operation completed.

    Deliberately NOT a TimeoutError subclass: on Python >= 3.11
    asyncio.TimeoutError IS the builtin TimeoutError, and a retry handler
    catching it would swallow a deadline expiry as a transient fault.
    The serving replica raises it for a request whose deadline (the
    ``_private.deadlines`` context at enqueue) passed before admission or
    mid-decode, and for a prefill asked for after its deadline: the work
    was abandoned because its budget ran out, so callers should treat the
    result as unavailable, not retry blindly."""


class OverloadedError(RayError):
    """A serving admission queue shed this request (load shedding).

    Raised by the serving replica when its admission queue exceeds its
    bound: either the absolute ``max_queue`` or the deadline-aware bound
    (the estimated queue wait already exceeds the request's remaining
    deadline budget, so admitting it would only burn decode capacity on a
    result the caller has written off). Carries ``retry_after_s``, the
    replica's own estimate of when capacity frees up: callers back off and
    retry, they never see a hang."""

    def __init__(self, message: str = "overloaded",
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class StreamBrokenError(RayError):
    """A streaming response died mid-stream and cannot be transparently
    resumed.

    Raised to a stream's consumer when its request was retired with an
    error after tokens were delivered (the serving replica raises it for a
    paged request whose KV part could not be gathered, with the
    ``KVGatherError`` as ``__cause__``). Replaying the stream would
    duplicate tokens the client already rendered, so the failure surfaces
    typed, carrying ``tokens_emitted`` (items delivered before the break)
    so clients can resume at the application level."""

    def __init__(self, message: str = "stream broken",
                 tokens_emitted: int = 0):
        super().__init__(message)
        self.tokens_emitted = int(tokens_emitted)


class DeviceSpecMismatchError(RayError):
    """A device tensor violates its declared payload spec.

    Raised by ``_private.device_plane.validate_against_spec`` when a leaf
    of a value has another shape or dtype than the (shape, dtype) spec
    declared for it (the reference raises the same class when two stages
    of a compiled DAG declare specs that disagree, at compile time)."""
