"""End-to-end deadline context, a copy of ray_tpu/_private/deadlines.py.

The deadline is an absolute ``time.time()`` instant. In the reference the
executing worker installs the one a task was submitted with; in the port
the caller installs it with ``set_current`` (and ``reset``) around the
calls it makes. The serving replica reads it when a request is enqueued,
so work that later runs on an executor thread never needs it.

A contextvar (not a bare thread-local) so it follows async code across
awaits; contextvars do not cross a ``run_in_executor`` boundary, which is
why the replica captures the deadline before it hands work to a thread.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

_task_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "task_deadline", default=None)


def get() -> Optional[float]:
    """Absolute wall-clock deadline of the currently-executing task, or
    None when no deadline is in force."""
    return _task_deadline.get()


def remaining() -> Optional[float]:
    """Seconds of budget left, clamped at 0.0; None when no deadline."""
    d = _task_deadline.get()
    return None if d is None else max(0.0, d - time.time())


def expired() -> bool:
    d = _task_deadline.get()
    return d is not None and time.time() > d


def set_current(deadline: Optional[float]):
    """Install (returns a reset token for contextvars.reset)."""
    return _task_deadline.set(deadline)


def reset(token) -> None:
    _task_deadline.reset(token)
