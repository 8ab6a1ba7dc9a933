"""The runtime settings the port reads, copied from ray_tpu/_private/config.py.

Each has the reference's default and, as there, is overridden by
``RAY_TPU_<name>`` in the process environment. The port keeps its own copy
because it imports nothing of ``ray_tpu``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

_SETTINGS: Dict[str, Tuple[type, Any]] = {
    # LRU-evicted prefix-cache pages demote to host memory (overflowing to
    # files) instead of being freed; a later hit promotes them back.
    "kv_cache_demotion_enabled": (bool, True),
    # Byte bound on the demoted tier's host window.
    "kv_demoted_bytes_limit": (int, 256 * 1024 * 1024),
    # Where demoted pages overflow to; empty = the temp directory.
    "object_spill_dir": (str, ""),
    # The per-process flight recorder (_private/flight_recorder.py): on or
    # off, and its ring's slots.
    "flight_recorder_enabled": (bool, True),
    "flight_recorder_capacity": (int, 4096),
}


def setting(name: str) -> Any:
    """The setting's value: ``RAY_TPU_<name>`` when set, else the default.
    A bool reads true from "1", "true" or "yes" (any case)."""
    typ, default = _SETTINGS[name]
    env = os.environ.get(f"RAY_TPU_{name}")
    if env is None:
        return default
    if typ is bool:
        return env.lower() in ("1", "true", "yes")
    return typ(env)
