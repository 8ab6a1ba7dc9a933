"""LLM serving on the port's engine: continuous batching, token streaming,
deadlines, load shedding, and the P/D and paged handoffs.

A port of ray_tpu/llm/serving.py. :class:`EngineReplica` is the serving
callable: one asyncio decode loop owns an :class:`~.engine.LLMEngine`, and
every request is a per-request stream fed from the loop's tick events.

  - **Continuous batching**: ``stream_generate`` enqueues into the engine's
    admission queue and returns at once; the decode loop admits per tick
    against page-pool occupancy and retires per tick (Orca's
    iteration-level scheduling, Yu et al., OSDI'22).
  - **Token streaming**: each emitted token lands in the request's queue;
    a consumer that goes away (``aclose``) cancels its request, and its
    pages return to the pool mid-decode.
  - **Deadlines**: the ambient deadline (``_private.deadlines``) is read
    at enqueue; a queued request whose budget expires fails typed
    (:class:`DeadlineExceededError`) without occupying a slot, and an
    admitted one is cancelled mid-decode.
  - **Load shedding**: admission sheds with a typed
    :class:`OverloadedError` (with ``retry_after_s``) once the queue
    reaches ``max_queue`` or the estimated queue wait exceeds the
    request's remaining deadline budget.

All engine access is serialised by one FIFO ``asyncio.Lock``; the engine's
compute (``step``, the prefills, ``sample_first``) runs on the event loop's
default executor threads, so admissions and stream consumers keep being
served between ticks. Engine work stays on the default CUDA stream, as in
the closed loop, whichever thread takes a tick.

Flight recorder (_private/flight_recorder.py), beside the engine's own
spans: the ``request:admit`` span (category ``request``), from enqueue to
the fan-out of the request's first token, with ``queued`` and
``decoding`` and two waits as arguments (not spans, so that they add no
interval of their own to a trace's timeline): ``lock_wait_us``, from the
route's call for the replica's lock (``_stream``, ``admit_external``,
``admit_paged``) to the enqueue, and ``hold_us``, from the first token
reaching the host (its sampling wave's sync, or the emit of a shipped
first token) to its hand-off to the stream, left out when the engine kept
no stamp of it. ``replica:fan_out`` (category ``replica``) covers each
tick's fan-out, and the ``request:cancelled`` and ``request:kv_broken``
instants mark the ends that are not finishes.

The runtime boundary: the port imports nothing of ``ray_tpu``, so the
runtime services the reference calls become callbacks of the constructor.
``kv_fetch(handle)`` resolves a KV part that is not passed by value (the
reference's ``ray_tpu.get``), and the replica's two-thread ``kv-gather``
pool runs it ahead of the decode loop to warm a part; ``publish(x) ->
handle`` replaces ``ray_tpu.put`` for prefill handoffs and
paged parts (default: by value); ``resolve(handle)``, sync or awaitable,
replaces awaiting an object ref in a handoff (default: the identity).

`run_open_loop` is the arrival-rate-driven (never closed-loop) load
harness: it offers requests on a fixed schedule regardless of completions
and reports p50/p99 TTFT, inter-token latency and tokens/s.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import logging
import os
import threading
import time
from typing import (Any, AsyncIterator, Dict, List, Optional, Sequence,
                    Union)

import numpy as np
import torch

from .._private import deadlines, flight_recorder
from ..exceptions import (DeadlineExceededError, OverloadedError, RayError,
                          StreamBrokenError)
from ..models import PRESETS
from ..models.transformer import TransformerConfig
from .engine import LLMEngine, SamplingParams, _default_kv_fetch

logger = logging.getLogger("ray_tpu_torch.llm.serving")

__all__ = ["EngineReplica", "run_open_loop"]


class _StreamEnd:
    """Terminal stream item: generation finished."""

    __slots__ = ("finish_reason", "n_tokens")

    def __init__(self, finish_reason: str, n_tokens: int):
        self.finish_reason = finish_reason
        self.n_tokens = n_tokens


class EngineReplica:
    """One continuous-batching engine behind an asyncio front.

    All public methods are async: they run on the caller's event loop
    while the device work happens on executor threads. Use one event loop
    for the replica's whole life (its lock and decode loop belong to it);
    from threads, submit through ``asyncio.run_coroutine_threadsafe``.

    ``cfg`` is a preset name or a ``TransformerConfig``; ``params`` are
    used as they are (no copy) and default to ``init_params`` from
    ``seed``. ``device`` defaults to ``"cuda"`` and raises without a GPU.
    The boundary callbacks are described in the module docstring.

    ``mesh``, ``rules``, ``sp_degree`` and ``sp_strategy`` go to the
    engine, which serves any mesh of one process under any rule table: sp,
    tp and pp alone or together, and replicas of such a layout over dp and
    fsdp (see ``LLMEngine``). The reference's replica takes no ``rules``
    (its engine's default, the Megatron table, is the port's too). Left on
    the runtime side: ``_flush_gauges`` (the runtime's metrics export) and
    ``_silence_watch`` (the diagnosis plane's anomaly detector).

    Diverges from the reference on a failed decode tick: the reference
    logs it and retries every 0.2 s, so a fault that repeats (a kernel
    that does not build or launch, a poisoned CUDA context) leaves every
    stream waiting forever. Here the exception is raised to every
    in-flight request's consumer and the replica serves no more requests:
    the engine's state after a failed step is not trusted. The cost: a
    transient fault (a CUDA out-of-memory in one admission wave) also ends
    the replica, where the reference's retry could recover. A fault of one
    request's input does not: a KV blob with a missing key or a wrong
    shape or dtype is refused at enqueue (``LLMEngine.add_external_request``)
    and raises to its own caller only."""

    def __init__(self, cfg: Union[str, TransformerConfig] = "tiny",
                 params=None, *, max_batch: int = 4, max_len: int = 128,
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 prefix_cache: bool = True, max_queue: int = 64,
                 max_tokens: int = 16, temperature: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0, mesh=None,
                 rules=None,
                 sp_degree: Optional[int] = None, sp_strategy: str = "ring",
                 prefill_chunk: Optional[int] = None,
                 kv_gather_window: int = 4, paged_span: int = 64,
                 kv_fetch=None, publish=None, resolve=None,
                 device: Union[str, torch.device] = "cuda"):
        cfg = PRESETS[cfg] if isinstance(cfg, str) else cfg
        # The gather pool overlaps KV-part fetches with decode compute (the
        # engine kicks prefetches before the attention loop reads parts).
        self._fetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="kv-gather")
        self._fetch = kv_fetch or _default_kv_fetch
        self._publish_fn = publish
        self._resolve = resolve
        self.engine = LLMEngine(cfg, params, max_batch=max_batch,
                                max_len=max_len, seed=seed,
                                page_size=page_size, kv_pages=kv_pages,
                                prefix_cache=prefix_cache,
                                sp_degree=sp_degree,
                                sp_strategy=sp_strategy, mesh=mesh,
                                rules=rules,
                                prefill_chunk=prefill_chunk,
                                kv_gather_window=kv_gather_window,
                                kv_fetch=self._kv_fetch,
                                kv_prefetch=self._kv_prefetch,
                                device=device)
        self.paged_span = int(paged_span)
        self.defaults = SamplingParams(max_tokens=max_tokens,
                                       temperature=temperature,
                                       eos_id=eos_id)
        self.max_queue = int(max_queue)
        self._lock = asyncio.Lock()        # serializes ALL engine access
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        # req_id -> consumer queue / metadata for in-flight streams.
        self._waiters: Dict[int, asyncio.Queue] = {}
        self._meta: Dict[int, Dict[str, Any]] = {}
        # EMA of request wall time: the shed path's queue-wait estimate.
        self._req_s_ema = 0.25
        self._ticks = 0
        self._max_active = 0
        self._shed = 0
        self._cancelled = 0
        self._expired = 0
        self._completed = 0
        self._tokens_out = 0
        self._kv_broken = 0
        # The exception of a failed decode tick; set, the replica is done.
        self._failed: Optional[BaseException] = None

    # ------------------------------------------------------------ helpers --
    def _kv_fetch(self, handle):
        """Blocking KV-part resolve (engine gather window, executor
        thread): by-value dicts pass through; other handles go to
        ``kv_fetch``."""
        if isinstance(handle, dict):
            return handle
        return self._fetch(handle)

    def _kv_prefetch(self, handle):
        """Async KV-part warm (returns a Future with .result()): runs
        ``kv_fetch`` on the gather pool so the pull overlaps decode
        compute."""
        if isinstance(handle, dict):
            f: concurrent.futures.Future = concurrent.futures.Future()
            f.set_result(handle)
            return f
        return self._fetch_pool.submit(self._fetch, handle)

    def _publish(self, x):
        return x if self._publish_fn is None else self._publish_fn(x)

    def _params(self, opts: Optional[dict]) -> SamplingParams:
        o = opts or {}
        d = self.defaults
        return SamplingParams(
            max_tokens=int(o.get("max_tokens", d.max_tokens)),
            temperature=float(o.get("temperature", d.temperature)),
            eos_id=o.get("eos_id", d.eos_id))

    def __serve_load__(self) -> float:
        """Autoscaling metric: queue depth × page-pool occupancy.  A deep
        queue against a full pool reads as heavy load; the same queue
        against a mostly-free pool (admission imminent) reads lighter;
        idle reads exactly 0 so scale-to-zero can trigger."""
        e = self.engine
        occ = e.kv_page_occupancy()
        return e.queue_depth * (1.0 + occ) + e.active_requests * max(occ,
                                                                     0.25)

    def _check_failed(self) -> None:
        if self._failed is not None:
            raise RayError(
                f"this replica's decode loop failed and serves no more "
                f"requests: {self._failed!r}") from self._failed

    def _maybe_shed(self, deadline: Optional[float]) -> None:
        self._check_failed()
        qd = self.engine.queue_depth
        est_wait = (qd / max(1, self.engine.max_batch)) * self._req_s_ema
        if qd >= self.max_queue:
            self._shed += 1
            raise OverloadedError(
                f"admission queue full ({qd} >= {self.max_queue})",
                retry_after_s=max(0.05, est_wait))
        if deadline is None:
            return
        now = time.time()
        if now > deadline:
            # Budget already spent (e.g. parked behind a long tick):
            # that's an expiry, not an overload — retrying the same
            # request would not help.
            self._expired += 1
            raise DeadlineExceededError(
                "deadline exceeded before serving admission queue")
        if now + est_wait > deadline:
            # Deadline-aware bound: admitting would burn decode capacity
            # on a result the caller has already written off.
            self._shed += 1
            raise OverloadedError(
                f"estimated queue wait {est_wait:.2f}s exceeds the "
                f"request's remaining deadline budget",
                retry_after_s=max(0.05, est_wait))

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.ensure_future(self._decode_loop())

    # --------------------------------------------------------- decode loop --
    async def _decode_loop(self):
        """The continuous-batching tick: admit per tick, ONE batched decode
        step for every active slot, retire per tick, fan tokens out to
        their streams. Engine compute runs on an executor thread so this
        loop stays responsive."""
        loop = asyncio.get_running_loop()
        while True:
            try:
                async with self._lock:
                    self._expire_overdue()
                    if self.engine.has_unfinished():
                        done = await loop.run_in_executor(
                            None, self.engine.step)
                        self._ticks += 1
                        self._max_active = max(self._max_active,
                                               self.engine.active_requests
                                               + len(done))
                        self._fan_out(self.engine.take_tick_events(), done)
                        # The retired requests go now, and with them the KV
                        # handles they hold, not when the next tick comes.
                        del done
                if not self.engine.has_unfinished():
                    self._wake.clear()
                    await self._wake.wait()
                else:
                    # One loop turn between ticks: lets freshly arrived
                    # requests enqueue (the lock is FIFO-fair) so they are
                    # admitted on the NEXT tick — iteration-level
                    # scheduling, not batch-level.
                    await asyncio.sleep(0)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.exception("decode loop tick failed; the replica "
                                 "stops serving")
                self._fail_in_flight(e)
                return

    def _fail_in_flight(self, err: BaseException) -> None:
        """Raise a failed tick's exception to every in-flight consumer and
        refuse further requests (see the class docstring)."""
        self._failed = err
        for rid, meta in self._meta.items():
            if meta.get("finished"):
                continue
            meta["finished"] = True
            q = self._waiters.get(rid)
            if q is not None:
                q.put_nowait(err)

    def _expire_overdue(self) -> None:
        """Fail queued requests whose deadline passed (typed, without
        ever occupying a slot) and cancel admitted ones mid-decode."""
        now = time.time()
        for rid, meta in list(self._meta.items()):
            dl = meta.get("deadline")
            if dl is None or now <= dl or meta.get("finished"):
                continue
            self._expired += 1
            self.engine.cancel_request(rid)
            q = self._waiters.get(rid)
            if q is not None:
                q.put_nowait(DeadlineExceededError(
                    "deadline exceeded in serving admission queue"
                    if not meta.get("admitted")
                    else "deadline exceeded mid-decode"))
            meta["finished"] = True

    def _fan_out(self, events, done_reqs) -> None:
        """Hand a tick's tokens and finishes to their streams, inside one
        ``replica:fan_out`` span; a request's first token closes its
        ``request:admit`` span."""
        rec = flight_recorder.recorder()
        t_fan = rec.begin()
        done_by_id = {r.req_id: r for r in done_reqs}
        for rid, tok, fin in events:
            meta = self._meta.get(rid)
            if meta is None:
                continue
            meta["t_last_tok"] = time.monotonic()
            q = self._waiters.get(rid)
            if q is not None:
                q.put_nowait(int(tok))
            if not meta.get("admitted"):
                meta["admitted"] = True
                meta["t_adm"] = time.monotonic()
                put = time.monotonic_ns()
                on_host = self.engine.first_token_ns(rid)
                waits = {"lock_wait_us": meta["lock_wait_us"]}
                if on_host is not None:
                    waits["hold_us"] = (put - on_host) // 1000
                rec.end("request", "request:admit", meta["t0"],
                        id=rid.to_bytes(8, "little"),
                        queued=self.engine.queue_depth,
                        decoding=max(0, self.engine.active_requests - 1
                                     + len(done_by_id)),
                        **waits)
        for rid, req in done_by_id.items():
            meta = self._meta.get(rid)
            if meta is not None and not meta.get("finished"):
                meta["finished"] = True
                q = self._waiters.get(rid)
                if req.finish_reason == "error" and req.error is not None:
                    # A KV part could not be gathered mid-decode: the
                    # engine retired the request typed (KVGatherError,
                    # pages already back in the pool) and never emitted a
                    # wrong token. Surface it as a broken stream carrying
                    # tokens_emitted, cause chained for diagnosis.
                    self._kv_broken += 1
                    rec.instant("request", "request:kv_broken",
                                id=rid.to_bytes(8, "little"),
                                tokens=len(req.out))
                    if q is not None:
                        err = StreamBrokenError(
                            f"remote KV lost mid-decode: {req.error}",
                            tokens_emitted=len(req.out))
                        err.__cause__ = req.error
                        q.put_nowait(err)
                    continue
                self._completed += 1
                self._tokens_out += len(req.out)
                # SERVICE time (admission -> finish), not enqueue ->
                # finish: folding queue wait into the EMA would make
                # the shed estimate grow quadratically with depth.
                dur = time.monotonic() - meta.get("t_adm",
                                                  meta["t_mono"])
                self._req_s_ema += 0.2 * (dur - self._req_s_ema)
                if q is not None:
                    q.put_nowait(_StreamEnd(req.finish_reason,
                                            len(req.out)))
        rec.end("replica", "replica:fan_out", t_fan)

    # ------------------------------------------------------------ streams --
    def _register(self, rid: int, deadline: Optional[float], rec,
                  entered_ns: int) -> asyncio.Queue:
        """A queued request's consumer queue and metadata (under the
        lock); ``entered_ns``: ``time.monotonic_ns()`` when its route
        went for the lock."""
        q: asyncio.Queue = asyncio.Queue()
        self._waiters[rid] = q
        t0 = rec.begin()
        self._meta[rid] = {"deadline": deadline, "t0": t0,
                           "lock_wait_us": (t0 - entered_ns) // 1000,
                           "t_mono": time.monotonic(),
                           "admitted": False, "finished": False}
        return q

    async def _stream(self, prompt_tokens: Optional[Sequence[int]],
                      opts: Optional[dict], *, external: Optional[tuple]
                      = None, cache_prompt: Optional[Sequence[int]] = None
                      ) -> AsyncIterator[Any]:
        """Shared producer for stream_generate / generate / decode: yields
        int tokens then one `_StreamEnd`.  Typed failures (shed, deadline,
        engine rejection) raise out of the first `anext`."""
        params = self._params(opts)
        deadline = deadlines.get()
        rec = flight_recorder.recorder()
        entered = time.monotonic_ns()
        async with self._lock:
            # Shed check INSIDE the lock: concurrent arrivals during a
            # decode tick must each see the true queue depth, not a
            # pre-tick snapshot (they would all pass a stale bound).
            self._maybe_shed(deadline)
            if external is not None:
                blob, first = external
                rid = self.engine.add_external_request(
                    blob, first, params, prompt_tokens=cache_prompt)
            else:
                rid = self.engine.add_request(list(prompt_tokens), params)
            q = self._register(rid, deadline, rec, entered)
        self._ensure_loop()
        self._wake.set()
        try:
            while True:
                item = await q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
                if isinstance(item, _StreamEnd):
                    return
        finally:
            await self._release(rid)

    async def _release(self, rid: int) -> None:
        meta = self._meta.pop(rid, None)
        self._waiters.pop(rid, None)
        if meta is not None and not meta.get("finished"):
            # Consumer went away mid-generation (client disconnect /
            # typed cancellation): retire now, pages return mid-decode.
            self._cancelled += 1
            flight_recorder.recorder().instant(
                "request", "request:cancelled",
                id=rid.to_bytes(8, "little"))
            async with self._lock:
                self.engine.cancel_request(rid)

    async def stream_generate(self, prompt_tokens: Sequence[int],
                              opts: Optional[dict] = None
                              ) -> AsyncIterator[Any]:
        """Async generator: int tokens as they decode, then one terminal
        dict ``{"finish_reason": ..., "n_tokens": ...}``."""
        it = self._stream(prompt_tokens, opts)
        try:
            async for item in it:
                if isinstance(item, _StreamEnd):
                    yield {"finish_reason": item.finish_reason,
                           "n_tokens": item.n_tokens}
                else:
                    yield item
        finally:
            # async-for does not close the inner generator on early exit;
            # close it NOW so an abandoned stream cancels its request (and
            # frees its pages) deterministically, not at a later GC.
            await it.aclose()

    async def generate(self, prompt_tokens: Sequence[int],
                       opts: Optional[dict] = None) -> Dict[str, Any]:
        """Non-streaming completion over the same continuous-batching
        machinery: {"tokens": [...], "finish_reason": ...}."""
        out: List[int] = []
        reason = ""
        async for item in self._stream(prompt_tokens, opts):
            if isinstance(item, _StreamEnd):
                reason = item.finish_reason
            else:
                out.append(item)
        return {"tokens": out, "finish_reason": reason}

    async def __call__(self, prompt_tokens: Sequence[int],
                       opts: Optional[dict] = None) -> List[int]:
        """DP-pattern compatibility surface: plain token list."""
        return (await self.generate(prompt_tokens, opts))["tokens"]

    # -------------------------------------------------- P/D disaggregation --
    async def prefill(self, prompt_tokens: Sequence[int],
                      opts: Optional[dict] = None):
        """Prefill half: (kv_blob, first_token) for a decode replica, the
        blob by value. Prefix-cache hits skip the shared span's compute."""
        params = self._params(opts)
        if deadlines.expired():
            raise DeadlineExceededError(
                "deadline exceeded before prefill started")
        loop = asyncio.get_running_loop()
        async with self._lock:
            self._check_failed()
            return await loop.run_in_executor(
                None, lambda: self.engine.prefill_only(
                    list(prompt_tokens), params))

    async def prefill_handoff(self, req: dict) -> dict:
        """Prefill half returning a HANDOFF: the KV blob goes through
        ``publish`` and only its handle travels onward; the decode side
        resolves it itself (``resolve``).

        ``req = {"prompt": [...], "opts": {...}}``; returns
        ``{"ref", "first", "opts", "prompt"}``."""
        prompt = list(req["prompt"])
        opts = req.get("opts") or {}
        params = self._params(opts)
        if deadlines.expired():
            raise DeadlineExceededError(
                "deadline exceeded before prefill started")
        loop = asyncio.get_running_loop()
        async with self._lock:
            self._check_failed()
            blob, first = await loop.run_in_executor(
                None, lambda: self.engine.prefill_only(prompt, params))
        return {"ref": self._publish(blob), "first": first, "opts": opts,
                "prompt": prompt}

    async def prefill_handoff_channel(self, req: dict) -> dict:
        """Prefill half whose KV blob travels by value in the handoff
        itself: ``{"blob", "first", "opts", "prompt"}``."""
        prompt = list(req["prompt"])
        opts = req.get("opts") or {}
        params = self._params(opts)
        if deadlines.expired():
            raise DeadlineExceededError(
                "deadline exceeded before prefill started")
        loop = asyncio.get_running_loop()
        async with self._lock:
            self._check_failed()
            blob, first = await loop.run_in_executor(
                None, lambda: self.engine.prefill_only(prompt, params))
        return {"blob": blob, "first": first, "opts": opts,
                "prompt": prompt}

    async def _resolve_handoff(self, handoff: dict):
        ref = handoff.get("ref")
        if ref is not None:
            if self._resolve is None:
                return ref
            blob = self._resolve(ref)
            if inspect.isawaitable(blob):
                blob = await blob
            return blob
        return handoff["blob"]

    async def admit_external(self, handoff: dict) -> int:
        """Resolve a KV handoff and admit it into the continuous batch,
        returning the request id WITHOUT waiting for completion. Tokens
        are collected with :meth:`collect` / :meth:`collect_stream`."""
        blob = await self._resolve_handoff(handoff)
        params = self._params(handoff.get("opts"))
        deadline = deadlines.get()
        rec = flight_recorder.recorder()
        entered = time.monotonic_ns()
        async with self._lock:
            self._maybe_shed(deadline)
            rid = self.engine.add_external_request(
                blob, handoff["first"], params,
                prompt_tokens=handoff.get("prompt"))
            self._register(rid, deadline, rec, entered)
        self._ensure_loop()
        self._wake.set()
        return rid

    async def collect(self, rid: int) -> Dict[str, Any]:
        """Drain an admitted request's stream to completion:
        ``{"tokens": [...], "finish_reason": ...}``."""
        out: List[int] = []
        reason = ""
        async for item in self.collect_stream(rid):
            if isinstance(item, dict):
                reason = item["finish_reason"]
            else:
                out.append(item)
        return {"tokens": out, "finish_reason": reason}

    async def collect_stream(self, rid: int):
        """Async generator over an admitted request: int tokens, then one
        terminal ``{"finish_reason", "n_tokens"}`` dict."""
        q = self._waiters.get(rid)
        if q is None:
            raise RayError(f"unknown or already-collected request {rid}")
        try:
            while True:
                item = await q.get()
                if isinstance(item, BaseException):
                    raise item
                if isinstance(item, _StreamEnd):
                    yield {"finish_reason": item.finish_reason,
                           "n_tokens": item.n_tokens}
                    return
                yield item
        finally:
            await self._release(rid)

    async def decode_handoff(self, handoff: dict) -> Dict[str, Any]:
        """Decode half over a handoff: admit through the SAME
        deadline-aware queue as local requests, decode to completion."""
        rid = await self.admit_external(handoff)
        return await self.collect(rid)

    async def decode(self, kv_blob: dict, first_token: int,
                     opts: Optional[dict] = None,
                     prompt_tokens: Optional[Sequence[int]] = None
                     ) -> Dict[str, Any]:
        """Decode half: admit a shipped KV blob through the SAME
        admission queue as local requests (deadline-aware, shed-bounded)
        and decode to completion."""
        out: List[int] = []
        reason = ""
        async for item in self._stream(None, opts, external=(
                kv_blob, first_token), cache_prompt=prompt_tokens):
            if isinstance(item, _StreamEnd):
                reason = item.finish_reason
            else:
                out.append(item)
        return {"tokens": out, "finish_reason": reason}

    # ------------------------------------------------------------ paged KV --
    async def prefill_paged_chunk(self, req: dict) -> dict:
        """ONE sequence-parallel prefill shard's unit of work: compute a
        chunk's KV stripe against the context parts before it (through
        the gather window), publish it and return its handle. ``req =
        {"chunk", "pos0", "parts", "span", "is_last", "opts"}``; the
        returned part dict drops straight into the next chunk's ``parts``
        and into the decode handoff. The LAST chunk also samples the
        prompt's first output token."""
        chunk = list(req["chunk"])
        pos0 = int(req["pos0"])
        span = int(req.get("span") or self.paged_span)
        parts = list(req.get("parts") or [])
        is_last = bool(req.get("is_last"))
        if deadlines.expired():
            raise DeadlineExceededError(
                "deadline exceeded before prefill chunk started")
        loop = asyncio.get_running_loop()
        first = None
        async with self._lock:
            self._check_failed()
            part, logits = await loop.run_in_executor(
                None, lambda: self.engine.prefill_paged_chunk(
                    chunk, pos0, parts, span=span, is_last=is_last))
            if is_last and logits is not None:
                # Inside the lock: sampling advances the engine RNG and
                # blocks on a device->host pull — both must not race the
                # decode loop's ticks (the one-FIFO-lock invariant).
                params = self._params(req.get("opts"))
                first = await loop.run_in_executor(
                    None, lambda: self.engine.sample_first(logits, params))
        out = {"span": (pos0, pos0 + len(chunk)),
               "handle": self._publish(part)}
        if first is not None:
            out["first"] = int(first)
        return out

    async def prefill_paged_handoff(self, req: dict) -> dict:
        """Whole-prompt streamed chunked prefill on this one replica: every
        stripe goes through ``publish`` and the handoff carries only their
        handles. ``req = {"prompt", "opts", "span"?}``; returns
        ``{"parts", "len", "first", "opts"}`` for :meth:`decode_paged` /
        :meth:`admit_paged`. Give the replica a ``kv_gather_window`` of at
        least the part count (see ``LLMEngine.prefill_paged``)."""
        prompt = list(req["prompt"])
        opts = req.get("opts") or {}
        span = int(req.get("span") or self.paged_span)
        params = self._params(opts)
        if deadlines.expired():
            raise DeadlineExceededError(
                "deadline exceeded before prefill started")
        loop = asyncio.get_running_loop()
        async with self._lock:
            self._check_failed()
            handoff = await loop.run_in_executor(
                None, lambda: self.engine.prefill_paged(
                    prompt, params, span=span, publish=self._publish_fn))
        handoff["opts"] = opts
        return handoff

    async def admit_paged(self, handoff: dict) -> int:
        """Admit a paged handoff (context KV in external parts) into the
        continuous batch through the SAME deadline-aware, shed-bounded
        queue as every other request; returns the request id for
        :meth:`collect` / :meth:`collect_stream`. Only the decode tail
        occupies this replica's pool pages."""
        params = self._params(handoff.get("opts"))
        deadline = deadlines.get()
        rec = flight_recorder.recorder()
        entered = time.monotonic_ns()
        async with self._lock:
            self._maybe_shed(deadline)
            rid = self.engine.add_paged_request(
                handoff["parts"], handoff["len"], handoff["first"],
                params, prompt_tokens=handoff.get("prompt"))
            self._register(rid, deadline, rec, entered)
        self._ensure_loop()
        self._wake.set()
        return rid

    async def decode_paged(self, handoff: dict) -> Dict[str, Any]:
        """Decode a paged handoff to completion. A KV part that cannot be
        gathered mid-decode raises :class:`StreamBrokenError` (carrying
        ``tokens_emitted``) out of this call — never a wrong token."""
        rid = await self.admit_paged(handoff)
        return await self.collect(rid)

    # ------------------------------------------------------------- introspect
    async def debug_stats(self) -> Dict[str, Any]:
        e = self.engine
        return {"ticks": self._ticks, "max_active": self._max_active,
                "shed": self._shed, "cancelled": self._cancelled,
                "expired": self._expired, "completed": self._completed,
                "tokens_out": self._tokens_out,
                "kv_broken": self._kv_broken,
                "queue_depth": e.queue_depth,
                "active": e.active_requests,
                "kv_pages_free": e.kv_pages_free(),
                "kv_pages_total": e.kv_pages_total,
                "load": self.__serve_load__(),
                "prefix_cache": e.prefix_cache_stats(),
                "kv_gather": e.kv_gather_stats()}

    async def pid(self) -> int:
        return os.getpid()


# ---------------------------------------------------------------------------
# Open-loop load harness
# ---------------------------------------------------------------------------

def _pctl(xs: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs), p)) if xs else 0.0


def run_open_loop(submit, *, rate_hz: float, duration_s: float,
                  prompt_fn, num_replicas: int = 1,
                  request_timeout_s: float = 120.0) -> Dict[str, Any]:
    """Arrival-rate-driven load harness — OPEN loop, never closed: the
    next request is offered on schedule whether or not earlier ones
    completed, so queueing delay shows up in the latency numbers instead
    of silently throttling the offered load (the classic closed-loop
    measurement bug).

    ``submit(prompt) -> iterable`` must yield stream items (int tokens,
    then a terminal dict with ``finish_reason``); for a replica on an
    event loop in another thread, bridge ``stream_generate`` with
    ``asyncio.run_coroutine_threadsafe``.

    Returns a report with p50/p99 TTFT (ms), p50/p99 inter-token latency
    (ms), tokens/s (total and per replica), max concurrent in-flight
    requests, and shed/error counts."""
    n = max(1, int(rate_hz * duration_s))
    lock = threading.Lock()
    state = {"active": 0, "max_active": 0}
    results: List[Dict[str, Any]] = []
    threads: List[threading.Thread] = []
    t_start = time.perf_counter()

    def _one(i: int):
        rec: Dict[str, Any] = {"ok": False, "shed": False, "error": None,
                               "broken": False}
        with lock:
            state["active"] += 1
            state["max_active"] = max(state["max_active"], state["active"])
        t_sub = time.perf_counter()
        try:
            first = prev = None
            gaps: List[float] = []
            ntok = 0
            for item in submit(prompt_fn(i)):
                now = time.perf_counter()
                if isinstance(item, dict):
                    rec["finish_reason"] = item.get("finish_reason")
                    break
                ntok += 1
                if first is None:
                    first = now
                if prev is not None:
                    gaps.append(now - prev)
                prev = now
            rec.update(ok=True, ttft_s=(first - t_sub) if first else None,
                       total_s=time.perf_counter() - t_sub, gaps=gaps,
                       tokens=ntok)
        except OverloadedError as e:
            rec["shed"] = True
            rec["retry_after_s"] = e.retry_after_s
        except StreamBrokenError as e:
            rec["broken"] = True
            rec["tokens_emitted"] = e.tokens_emitted
        except Exception as e:  # noqa: BLE001 — the harness reports, never dies
            rec["error"] = repr(e)
        finally:
            with lock:
                state["active"] -= 1
            with lock:
                results.append(rec)

    for i in range(n):
        target = t_start + i / rate_hz
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=_one, args=(i,), daemon=True)
        th.start()
        threads.append(th)
    deadline = time.perf_counter() + request_timeout_s
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    wall = time.perf_counter() - t_start

    done = [r for r in results if r.get("ok")]
    ttfts = [r["ttft_s"] * 1e3 for r in done if r.get("ttft_s") is not None]
    gaps = [g * 1e3 for r in done for g in r.get("gaps", ())]
    tokens = sum(r.get("tokens", 0) for r in done)
    return {
        "offered": n,
        "completed": len(done),
        "shed": sum(1 for r in results if r.get("shed")),
        "broken": sum(1 for r in results if r.get("broken")),
        "errors": [r["error"] for r in results if r.get("error")],
        "unfinished": n - len(results),
        "max_inflight": state["max_active"],
        "ttft_p50_ms": _pctl(ttfts, 50),
        "ttft_p99_ms": _pctl(ttfts, 99),
        "total_p50_ms": _pctl([r["total_s"] * 1e3 for r in done], 50),
        "itl_p50_ms": _pctl(gaps, 50),
        "itl_p99_ms": _pctl(gaps, 99),
        "tokens_total": tokens,
        "duration_s": wall,
        "tokens_per_s": tokens / wall if wall > 0 else 0.0,
        "tokens_per_s_per_replica":
            tokens / wall / max(1, num_replicas) if wall > 0 else 0.0,
    }
