"""The runtime services the rllib training loop calls, as one object.

The reference's Algorithm calls ``ray_tpu.remote``, ``put``, ``get``,
``wait`` and ``kill`` (env runners, aggregators and remote learners are
actors). The port takes those five calls from a runtime object that the
caller gives ``Algorithm``, so its loop reads as the reference's
does. ``LocalRuntime`` runs everything in the calling process; a caller
that hosts the port under a cluster runtime gives an adapter with the
same five methods (the tests map them onto ``ray_tpu``).

The protocol:

- ``remote(cls, **resources)`` returns a constructor: calling it with
  ``cls``'s arguments makes an actor and returns its handle. A handle's
  method is called as ``handle.method.remote(*args)`` and returns a
  reference; references passed as arguments arrive resolved.
- ``put(value)`` returns a reference to ``value``; ``get(ref_or_refs,
  timeout=None)`` the value or values.
- ``wait(refs, num_returns=1, timeout=None)`` returns ``(ready,
  not_ready)``, at most ``num_returns`` in ``ready``.
- ``kill(handle)`` ends the actor.
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional, Sequence, Tuple


class LocalRef:
    """A finished result (LocalRuntime's references are never pending)."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value


def _resolve(x):
    return x.value if isinstance(x, LocalRef) else x


class _LocalMethod:
    def __init__(self, fn):
        self._fn = fn

    def remote(self, *args, **kwargs) -> LocalRef:
        return LocalRef(self._fn(*[_resolve(a) for a in args],
                                 **{k: _resolve(v) for k, v in
                                    kwargs.items()}))


class LocalHandle:
    """An in-process actor: ``handle.m.remote(...)`` calls ``m`` now and
    returns its result as a finished reference. ``instance`` is the
    object itself."""

    def __init__(self, instance: Any):
        self.instance = instance

    def __getattr__(self, name: str) -> _LocalMethod:
        return _LocalMethod(getattr(self.instance, name))


class LocalRuntime:
    """Every actor in this process, every call finished when it returns.

    Constructor arguments are deep-copied, as a cluster runtime's pickling
    copies them, so each actor owns its arguments (each env runner its own
    connector state). Method arguments and results are passed as they are:
    the learner's ``get_weights`` is already a snapshot, and a runner's
    samples are fresh arrays. ``resources`` are accepted and ignored."""

    def remote(self, cls: type, **resources):
        del resources

        def make(*args, **kwargs) -> LocalHandle:
            args, kwargs = copy.deepcopy((args, kwargs))
            return LocalHandle(cls(*args, **kwargs))
        return make

    def put(self, value: Any) -> LocalRef:
        return LocalRef(value)

    def get(self, refs, timeout: Optional[float] = None):
        del timeout
        if isinstance(refs, (list, tuple)):
            return [_resolve(r) for r in refs]
        return _resolve(refs)

    def wait(self, refs: Sequence[LocalRef], num_returns: int = 1,
             timeout: Optional[float] = None
             ) -> Tuple[List[LocalRef], List[LocalRef]]:
        del timeout
        refs = list(refs)
        return refs[:num_returns], refs[num_returns:]

    def kill(self, handle: LocalHandle) -> None:
        del handle
