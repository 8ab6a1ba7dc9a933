"""The process's own flight-recorder rows, for readers of spans that
``drivers/`` does not hand the harness.

``drivers/train.py`` passes no spans (its result's ``"spans"`` is empty), so
the readers of the train step's spans (``train:grad``,
``train:optimizer``) read the process's recorder here after the run. The
recorder is drained once per process, the first time a reader asks, and
its rows are kept for every reader after. By then the run has synchronised
the device, so every device-timed span has its ``device_us``.
"""

from __future__ import annotations

import statistics
from typing import List, Optional

_rows: Optional[List[dict]] = None


def rows() -> List[dict]:
    """Every row the process's flight recorder holds, drained once."""
    global _rows
    if _rows is None:
        from ray_tpu_torch._private import flight_recorder
        _rows = flight_recorder.recorder().drain()
    return _rows


def window_steps_ms(name: str) -> Optional[float]:
    """Median ``device_us`` of the ``name`` spans of the window's train
    steps (``step`` at or past ``CHECK_STEPS`` of ``drivers/train.py``:
    not the warm-up), in ms; None where there are none."""
    from .drivers.train import CHECK_STEPS
    xs = [a["device_us"] / 1e3 for a in (
        r.get("args") or {} for r in rows() if r["name"] == name)
        if "device_us" in a and a.get("step", -1) >= CHECK_STEPS]
    return statistics.median(xs) if xs else None
