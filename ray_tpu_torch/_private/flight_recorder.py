"""Flight recorder: a low-overhead in-process event ring.

A copy of ray_tpu/_private/flight_recorder.py, for the port's engine and
serving replica. Each process owns a preallocated ring of (start-ns,
end-ns, category, name, id, args) records; recording is one slot store and
an index bump under a lock, from any thread. ``drain()`` turns the records
into rows with the reference's keys (``task_id``, ``name``,
``event="SPAN"``, ``cat``, ``ts``, ``start_us``, ``dur_us``, ``worker_id``,
``node_id``, ``job_id`` and ``args`` when there are any).

The engine writes spans in the ``request`` category: ``prefill`` (with
``cached_tokens``, and ``chunked`` or ``external`` where they apply),
``decode`` (one per batched decode step, with ``batch``), ``sample_sync``
(one per sampling wave, with ``batch``) and ``sp:gather`` (one per streamed
decode token or paged prefill chunk, with the gather window's counters).
``flight_recorder_enabled`` turns recording off; ``flight_recorder_capacity``
sizes the ring.

Overflow drops the OLDEST record and counts it in ``dropped``, so a
truncated view is never mistaken for a complete one.

Times: starts and ends are ``time.monotonic_ns()``; ``drain()`` converts
them to this process's wall clock (``time.time()``) with one anchor per
drain. The reference's injected clock skew belongs to its runtime and is not
copied. Spans are host time: around work on a CUDA device they measure the
dispatch of the work plus whatever synchronisation the wrapped code does
(the engine's ``sample_sync`` holds its one device-to-host copy, so it
absorbs the device time queued before it).

The serving replica (llm/serving.py) adds the ``request:admit`` span
(enqueue to admission, with ``queued`` and ``decoding``) and the
``request:cancelled`` and ``request:kv_broken`` instants.
``flight_recorder_sample_n`` keeps 1 of every N ``instant()`` events per
category and counts the rest in ``sampled_out`` (spans are never sampled
away: their rate is bounded by the operations they wrap).

Not copied: the reference's category gate (``flight_recorder_categories``
and ``active()``): every row the port writes is in the ``request``
category, so the gate would only repeat ``flight_recorder_enabled``;
``export_rows``, which feeds the reference runtime's metrics
export (RPC counters and copy audit) and has no counterpart in the port;
``note_lost`` and the ``span()`` context manager, which only that
runtime calls.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .. import _config


class FlightRecorder:
    def __init__(self, capacity: int = 4096, sample_n: int = 1,
                 enabled: bool = True):
        self.capacity = max(16, int(capacity))
        self._ring: list = [None] * self.capacity
        self._head = 0          # next write slot
        self._count = 0         # live records (<= capacity)
        self._lock = threading.Lock()
        self._sample_n = max(1, int(sample_n))
        self._sample_ctr: Dict[str, int] = {}
        self.enabled = enabled
        self.recorded = 0       # accepted records (monotonic)
        self.dropped = 0        # overwritten-before-drain records
        self.sampled_out = 0    # instants skipped by sampling

    # ------------------------------------------------------------ record --
    def _push(self, rec: tuple) -> None:
        with self._lock:
            if self._count == self.capacity:
                self.dropped += 1       # overwriting the oldest
            else:
                self._count += 1
            self._ring[self._head] = rec
            self._head = (self._head + 1) % self.capacity
            self.recorded += 1

    def instant(self, cat: str, name: str, id: bytes = b"",
                **args) -> None:
        """Point event. Subject to per-category 1-in-N sampling."""
        if not self.enabled:
            return
        if self._sample_n > 1:
            with self._lock:        # instants may come from any thread
                c = self._sample_ctr.get(cat, 0)
                self._sample_ctr[cat] = c + 1
                if c % self._sample_n:
                    self.sampled_out += 1
                    return
        t = time.monotonic_ns()
        self._push((t, t, cat, name, id, args or None))

    def begin(self) -> int:
        """Start stamp for a span; pass it to end()."""
        return time.monotonic_ns()

    def end(self, cat: str, name: str, t0_ns: int, id: bytes = b"",
            **args) -> None:
        """Complete a span started at begin(). Spans are never sampled
        away."""
        if not self.enabled:
            return
        self._push((t0_ns, time.monotonic_ns(), cat, name, id, args or None))

    # ------------------------------------------------------------- drain --
    def drain(self, node_id: bytes = b"",
              worker_id: bytes = b"") -> List[dict]:
        """Swap the ring out and return its records as rows, oldest first.
        Monotonic stamps convert to wall time at drain (one anchor per
        drain; monotonic spacing is kept exactly)."""
        with self._lock:
            if not self._count:
                return []
            if self._count == self.capacity:
                recs = (self._ring[self._head:]
                        + self._ring[:self._head])
            else:
                start = (self._head - self._count) % self.capacity
                if start + self._count <= self.capacity:
                    recs = self._ring[start:start + self._count]
                else:
                    recs = (self._ring[start:]
                            + self._ring[:self._head])
            self._ring = [None] * self.capacity
            self._head = 0
            self._count = 0
        anchor_mono = time.monotonic_ns()
        anchor_wall = time.time()
        out: List[dict] = []
        for t0, t1, cat, name, rid, args in recs:
            start_s = anchor_wall - (anchor_mono - t0) / 1e9
            rec = {
                "task_id": rid or b"",
                "name": name,
                "event": "SPAN",
                "cat": cat,
                "ts": start_s,
                "start_us": int(start_s * 1e6),
                "dur_us": max(0, (t1 - t0) // 1000),
                "worker_id": worker_id,
                "node_id": node_id,
                "job_id": b"",
            }
            if args:
                rec["args"] = args
            out.append(rec)
        return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            pending = self._count
        return {"recorded": self.recorded, "dropped": self.dropped,
                "sampled_out": self.sampled_out, "pending": pending}


_recorder: Optional[FlightRecorder] = None
_rec_lock = threading.Lock()


def recorder() -> FlightRecorder:
    """The per-process recorder, built from the settings on first use."""
    global _recorder
    if _recorder is None:
        with _rec_lock:
            if _recorder is None:
                _recorder = _from_config()
    return _recorder


def _from_config() -> FlightRecorder:
    """A recorder from the ``flight_recorder_*`` settings
    (``RAY_TPU_flight_recorder_*``); an unparsable value gives the
    defaults, as in the reference: the recorder never takes its process
    down."""
    try:
        return FlightRecorder(
            capacity=_config.setting("flight_recorder_capacity"),
            sample_n=_config.setting("flight_recorder_sample_n"),
            enabled=_config.setting("flight_recorder_enabled"))
    except ValueError:
        return FlightRecorder()


def reset() -> None:
    """Drop the singleton so that the next recorder() reads the settings
    again (tests; also right after a fork: each process records its own)."""
    global _recorder
    with _rec_lock:
        _recorder = None
