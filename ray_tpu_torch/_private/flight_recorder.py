"""Flight recorder: a low-overhead in-process event ring.

A copy of ray_tpu/_private/flight_recorder.py, for the port's train step,
engine and serving replica. Each process owns a preallocated ring of
(start-ns, end-ns, category, name, id, args, device timing) records;
recording is one slot store and an index bump under a lock, from any
thread. ``drain()`` turns the records into rows with the reference's keys
(``task_id``, ``name``, ``event="SPAN"``, ``cat``, ``ts``, ``start_us``,
``dur_us``, ``worker_id``, ``node_id``, ``job_id`` and ``args`` when there
are any).

The spans the port writes, by category:

- ``train`` (models/train_step.py), each with the state's ``step`` at
  entry and ``device_us``: ``train:grad``, from the leaves' detach to the
  end of the backward (under a mesh, every batch group's forward and
  backward and the replicas' all-reduce), and ``train:optimizer``, the
  global norm with its host sync, the AdamW update and, under a mesh, the
  replica copies.
- ``engine`` (llm/engine.py): ``engine:step``, one per ``LLMEngine.step``.
- ``request`` (llm/engine.py): ``prefill`` (with ``tokens``,
  ``cached_tokens``, ``active``, ``device_us``, and ``chunked`` or
  ``external`` where they apply; it ends when its work is dispatched),
  ``decode`` (one per batched decode step, up to its host sync, with
  ``batch``), ``sample_sync`` (one per sampling wave, with ``batch``) and ``sp:gather`` (one per streamed decode token or paged
  prefill chunk, with the gather window's counters).
- ``request`` and ``replica`` (llm/serving.py): ``request:admit``, from
  enqueue to the fan-out of the first token, with ``queued``,
  ``decoding``, ``lock_wait_us`` (the route's entry to its enqueue: the
  wait for the replica's lock) and ``hold_us`` (the first token on the host
  to its fan-out, left out when the engine kept no stamp of it);
  ``replica:fan_out``, one per tick; and the
  ``request:cancelled`` and ``request:kv_broken`` instants.

``flight_recorder_enabled`` turns recording off; ``flight_recorder_capacity``
sizes the ring. Overflow drops the OLDEST record and counts it in
``dropped``, so a truncated view is never mistaken for a complete one.

Device time: ``begin(device)`` with a CUDA device records a timing event on
that device's current stream, and ``end()`` a second one after the span's
work is queued; their elapsed time is the span's ``device_us`` argument:
the stream's time from the span's first queued work to its last, idle
stretches inside included. Nothing waits for the device: a pair resolves
once its end event has completed, found by a non-blocking ``query()`` as
later device-timed spans end and at ``drain()``. A drain returns every
record written before it: one whose end event has not completed yet comes
out without ``device_us``, and its pair goes back to the pool once it has.
Event pairs are reused. With no device, a CPU device or the recorder
disabled, ``begin()`` is one clock read and ``device_us`` is absent.

Times: starts and ends are ``time.monotonic_ns()``; ``drain()`` converts
them to this process's wall clock (``time.time()``) with one anchor per
drain. torch.profiler's exported trace is on the same wall clock once its
``baseTimeNanoseconds`` is added to each event's ``ts``, so a drained row
and a traced kernel compare directly. The reference's injected clock skew
belongs to its runtime and is not copied.
Host durations around work on a CUDA device measure its dispatch plus
whatever synchronisation the wrapped code does (``sample_sync`` holds its
one device-to-host copy, so it absorbs the device time queued before it).

Not copied: the reference's category gate (``flight_recorder_categories``
and ``active()``), which would only repeat ``flight_recorder_enabled``, and
its 1-in-N sampling of instants (``flight_recorder_sample_n``): the port's
instants come at most one per request; ``export_rows``, which feeds the
reference runtime's metrics export (RPC counters and copy audit) and has
no counterpart in the port; ``note_lost`` and the ``span()`` context
manager, which only that runtime calls.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from .. import _config


class _Timed:
    """A device-timed span in flight: its host start, its stream and its
    (start, end) timing events until they resolve into ``args`` (None
    once a drain has let the record go without its device time)."""

    __slots__ = ("t0", "stream", "pair", "args")

    def __init__(self, t0: int, stream, pair):
        self.t0 = t0
        self.stream = stream
        self.pair = pair
        self.args: Optional[dict] = None


class FlightRecorder:
    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.capacity = max(16, int(capacity))
        self._ring: list = [None] * self.capacity
        self._head = 0          # next write slot
        self._count = 0         # live records (<= capacity)
        self._lock = threading.Lock()
        self.enabled = enabled
        self.recorded = 0       # accepted records (monotonic)
        self.dropped = 0        # overwritten-before-drain records
        # Device-timed spans whose events have not resolved, oldest first,
        # and the idle event pairs of each device.
        self._pending: collections.deque = collections.deque()
        self._free: Dict[int, list] = {}

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
        """Point event."""
        if not self.enabled:
            return
        t = time.monotonic_ns()
        self._push((t, t, cat, name, id, args or None, None))

    def begin(self, device=None):
        """Start stamp for a span; pass it to end(). With a CUDA
        ``torch.device`` (and the recorder on) the span is timed on that
        device's current stream as well."""
        if device is None or not self.enabled \
                or getattr(device, "type", None) != "cuda":
            return time.monotonic_ns()
        import torch
        stream = torch.cuda.current_stream(device)
        with self._lock:
            free = self._free.get(stream.device_index)
            pair = free.pop() if free else None
        if pair is None:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        pair[0].record(stream)
        return _Timed(time.monotonic_ns(), stream, pair)

    def end(self, cat: str, name: str, t0_ns, id: bytes = b"",
            **args) -> None:
        """Complete a span started at begin()."""
        if not self.enabled:
            return
        t1 = time.monotonic_ns()
        if not isinstance(t0_ns, _Timed):
            self._push((t0_ns, t1, cat, name, id, args or None, None))
            return
        timed = t0_ns
        timed.pair[1].record(timed.stream)
        timed.args = args
        self._push((timed.t0, t1, cat, name, id, args, timed))
        with self._lock:
            self._pending.append(timed)
            while self._pending:
                head = self._pending[0]
                if head.pair is not None and not head.pair[1].query():
                    break
                self._pending.popleft()
                if head.pair is not None:
                    self._resolve(head)

    def _resolve(self, timed: _Timed) -> None:
        """Write a completed pair's elapsed time into the span's args,
        unless a drain already let them go, and return the pair to its
        device's pool (under the lock)."""
        start, end = timed.pair
        if timed.args is not None:
            timed.args["device_us"] = round(start.elapsed_time(end) * 1000.0)
        self._free.setdefault(timed.stream.device_index, []).append(
            timed.pair)
        timed.pair = None

    # ------------------------------------------------------------- drain --
    def drain(self, node_id: bytes = b"",
              worker_id: bytes = b"") -> List[dict]:
        """Swap the ring out and return its records as rows, oldest first.
        A device-timed record whose end event has not completed comes out
        without ``device_us``. Monotonic stamps convert to wall time at
        drain (one anchor per drain; monotonic spacing is kept exactly)."""
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
            for rec in recs:
                timed = rec[6]
                if timed is not None and timed.pair is not None:
                    if timed.pair[1].query():
                        self._resolve(timed)
                    else:
                        timed.args = None   # the pair stays in _pending
        anchor_mono = time.monotonic_ns()
        anchor_wall = time.time()
        out: List[dict] = []
        for t0, t1, cat, name, rid, args, _ in recs:
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
                "pending": pending}


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
            enabled=_config.setting("flight_recorder_enabled"))
    except ValueError:
        return FlightRecorder()


def reset() -> None:
    """Drop the singleton so that the next recorder() reads the settings
    again (tests; also right after a fork: each process records its own)."""
    global _recorder
    with _rec_lock:
        _recorder = None
