"""LLM serving patterns of the port over its serving replica, from
ray_tpu/llm/serve_patterns.py.

Every pattern serves with :class:`~.serving.EngineReplica`, the
continuous-batching replica (per-tick admission and retirement, token
streaming, prefix cache, deadline-aware shedding):

- ``build_llm_app``: the autoscaled data-parallel app, and
  ``build_dp_deployment``, the fixed-size one. Both return the port's
  ``serve.Application`` with the reference's deployment settings, bound to
  the replica's init args.
- ``run_pd_app``: prefill/decode disaggregation behind an ingress. The
  direct handoff publishes the KV blob into the prefill host's buffers and
  passes only its handle, which the decode replica resolves onto its own
  device; ``direct=False`` carries the blob by value.
- ``CompiledPDApp``: P/D over fixed lanes (a prefill and a decode replica
  each), the KV blob carried by the lane's edge.
- ``LongContextApp``: a long prompt prefilled in ``span``-token chunks
  round-robined over N shard replicas, each publishing its stripes into its
  own host buffers; decode replicas attend to the stripes through their
  gather window, holding only the decode tail in their pools.

The runtime boundary: the reference deploys replicas as Serve replicas or
actors and moves KV through the object store. The port hosts each replica in
this process on an asyncio loop of a thread of its own (``Hosted``, an
actor's counterpart: one replica keeps to one loop, and a blocking call of
one replica's stalls no other's); calls between hosts go through
``asyncio.run_coroutine_threadsafe``. A host's buffers
(``_HostBuffers``) stand in for its node's arena: ``publish`` serialises a
tensor tree into a host buffer of its own (one device-to-host copy a
tensor; pinned where the device is a card) and returns a ``HostRef``;
resolving the handle deserialises it onto the reader's device (one upload
a tensor). A buffer lives as long as its handle, as an object lives as
long as its last ref. Once a host is shut down its buffers are gone, and
resolving one of its handles raises ``KVGatherError``: the counterpart of
losing the node that held the object.

Every app takes ``preset`` (a name or a ``TransformerConfig``),
``params=None`` (default: ``init_params`` of the preset from ``seed``, what
each replica of the reference draws) and ``device="cuda"`` beside the
reference's arguments. ``prefill_options``/``decode_options`` take
``{"device": ...}``, the counterpart of a replica's resource request
(default: the app's device). Replicas on one device share one set of params;
a replica on another device gets one copy there, made once per device.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .. import serve
from .._device import resolve_device
from .._private import device_plane, serialization
from ..exceptions import KVGatherError
from ..models import PRESETS
from ..models.transformer import TransformerConfig, init_params
from .sequence_parallel import _tree_to
from .serving import EngineReplica

__all__ = ["build_llm_app", "build_dp_deployment", "run_pd_app",
           "CompiledPDApp", "run_pd_compiled", "LongContextApp",
           "run_long_context_app", "Hosted", "HostRef"]


# ---------------------------------------------------------------------------
# In-process hosting: host buffers, handles and the replica host.

@contextlib.contextmanager
def _landing(device: torch.device):
    """Rebuild device leaves on ``device`` in this thread for the block."""
    old = getattr(device_plane._tls, "landing", None)
    device_plane.set_landing_device(device)
    try:
        yield
    finally:
        if old is None:
            del device_plane._tls.landing
        else:
            device_plane._tls.landing = old


def _host_buffer(nbytes: int, device: torch.device) -> memoryview:
    """A host buffer of ``nbytes``, pinned where the device is a card."""
    return memoryview(torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=device.type == "cuda").numpy())


def _to_host(value, device: torch.device) -> memoryview:
    """``value`` serialised into a host buffer of its own (one
    device-to-host copy of each tensor)."""
    ctx = serialization.get_context()
    parts = ctx.serialize(value)
    buf = _host_buffer(ctx.total_size(parts), device)
    return buf[:serialization.write_parts_into(parts, buf)]


def _from_host(buf: memoryview, device: torch.device):
    """A value ``_to_host`` wrote, rebuilt onto ``device`` (one upload of
    each tensor)."""
    with _landing(device):
        return serialization.get_context().deserialize(buf)


def _channel_callbacks(device: torch.device):
    """(publish, resolve): publish serialises a KV blob into a host buffer
    of its own; resolve deserialises it onto ``device``."""
    return (lambda blob: _to_host(blob, device),
            lambda buf: _from_host(buf, device))


class HostRef:
    """Handle to a value a host published into its buffers. ``hex()`` is
    its key, as an object ref's is (the gather window keys parts by it).
    The buffer lives as long as the handle: when the last reference to it
    goes, the buffer is freed, as the object store frees an object when
    its last ref is dropped. A copy is the handle itself."""

    __slots__ = ("store", "key", "__weakref__")

    def __init__(self, store: "_HostBuffers", key: str):
        self.store = store
        self.key = key

    def hex(self) -> str:
        return self.key

    def __copy__(self) -> "HostRef":
        return self

    def __deepcopy__(self, memo) -> "HostRef":
        return self

    def __repr__(self) -> str:
        return f"HostRef({self.key})"


class _HostBuffers:
    """The host buffers one host published, its node arena's counterpart."""

    _ids = itertools.count()

    def __init__(self, device: torch.device):
        self.device = device
        self._tag = f"host{next(self._ids)}"
        self._seq = itertools.count()
        self._bufs: Dict[str, memoryview] = {}
        self._lock = threading.Lock()
        self._freed = False

    def publish(self, value) -> HostRef:
        """Serialise ``value`` into a host buffer of its own, freed when the
        returned handle's last reference goes."""
        buf = _to_host(value, self.device)
        key = f"{self._tag}:{next(self._seq)}"
        with self._lock:
            if self._freed:
                raise RuntimeError(f"{self._tag} is shut down")
            self._bufs[key] = buf
        ref = HostRef(self, key)
        weakref.finalize(ref, self._drop, key)
        return ref

    def _drop(self, key: str) -> None:
        # Runs wherever the handle's last reference goes, possibly inside
        # this store's own locked section: a single dict pop, no lock.
        self._bufs.pop(key, None)

    def fetch(self, ref: HostRef, device: torch.device, take: bool = False):
        """Deserialise ``ref``'s value onto ``device``; ``take`` frees its
        buffer (a handle with one reader). Raises KVGatherError once the
        buffer is gone."""
        with self._lock:
            buf = (self._bufs.pop(ref.key, None) if take
                   else self._bufs.get(ref.key))
            freed = self._freed
        if buf is None:
            raise KVGatherError(
                f"{ref!r} cannot be fetched: "
                + ("its host was shut down" if freed
                   else "no such buffer (already taken)"))
        return _from_host(buf, device)

    def free(self) -> None:
        with self._lock:
            self._freed = True
            self._bufs.clear()

    def __len__(self) -> int:
        return len(self._bufs)


class Hosted:
    """A replica (or an ingress, or nothing: a bare loop for replicas that
    share one) on an asyncio event loop of a thread of its own, as an actor
    hosts one (a replica keeps to one loop, and a blocking call of one
    replica's, a copy in its publish or resolve callback, stalls no
    other's). Callers on other threads submit through ``call`` and
    ``stream``. ``buffers`` are the host buffers it publishes into."""

    def __init__(self, replica=None,
                 buffers: Optional[_HostBuffers] = None):
        self.replica = replica
        self.buffers = buffers
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever,
                                        name="hosted-replica", daemon=True)
        self._thread.start()

    def call(self, coro, timeout: float = 600.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    async def acall(self, coro):
        """Await ``coro`` on this host's loop from another host's loop."""
        return await asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(coro, self.loop))

    def stream(self, agen, timeout: float = 600.0):
        """Iterate an async generator of the loop from this thread; closing
        early closes it (a replica then cancels the request)."""
        async def step():
            return await agen.__anext__()
        try:
            while True:
                try:
                    yield self.call(step(), timeout)
                except StopAsyncIteration:
                    return
        finally:
            self.call(agen.aclose(), timeout)

    def debug_stats(self, timeout: float = 60.0) -> Dict[str, Any]:
        return self.call(self.replica.debug_stats(), timeout)

    def shutdown(self) -> None:
        """Cancel the loop's tasks (a replica's idle decode loop), shut its
        executor down and stop the thread; then shut a replica's gather
        pool (an ingress's own hosts) down and free the buffers it
        published. Idempotent."""
        if self.loop.is_closed():
            return

        async def stop():
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await asyncio.get_running_loop().shutdown_default_executor()
        self.call(stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(60)
        self.loop.close()
        if isinstance(self.replica, EngineReplica):
            self.replica._fetch_pool.shutdown(wait=True)
        elif hasattr(self.replica, "shutdown"):
            self.replica.shutdown()
        if self.buffers is not None:
            self.buffers.free()

    close = shutdown    # the name util/perf.py's P/D pair callers use


def _fetch_onto(device: torch.device, take: bool = False):
    """A replica's ``kv_fetch`` (``take=False``) or ``resolve``
    (``take=True``) callback: a ``HostRef`` onto ``device``."""
    def fetch(ref: HostRef):
        return ref.store.fetch(ref, device, take)
    return fetch


def _host_replica(cfg, params, device: torch.device, **kw) -> Hosted:
    """An EngineReplica on ``device`` hosted with buffers of its own: it
    publishes into them, and fetches and resolves ``HostRef``s onto its
    device."""
    buffers = _HostBuffers(device)
    rep = EngineReplica(cfg, params, publish=buffers.publish,
                        kv_fetch=_fetch_onto(device),
                        resolve=_fetch_onto(device, take=True),
                        device=device, **kw)
    return Hosted(rep, buffers)


class _Placement:
    """An app's config and params per device: the params drawn once (or
    given) on the app's device, and ``.to`` another device once."""

    def __init__(self, preset, params, seed: int, device):
        self.cfg = PRESETS[preset] if isinstance(preset, str) else preset
        self.device = resolve_device(device)
        if params is None:
            params = init_params(
                self.cfg, torch.Generator(self.device).manual_seed(seed),
                self.device)
        self._params = params
        self._on: Dict[torch.device, Any] = {params["embed"].device: params}

    def device_of(self, options: Optional[dict]) -> torch.device:
        """The device a replica's options ask for (``{"device": ...}``)."""
        opts = dict(options or {})
        dev = resolve_device(opts.pop("device", self.device))
        if opts:
            raise TypeError(f"unsupported replica options {sorted(opts)}: "
                            f"the port's replicas take {{'device': ...}}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def params(self, device: torch.device):
        if device not in self._on:
            self._on[device] = _tree_to(self._params, device)
        return self._on[device]


def _shutdown_all(hosts) -> None:
    for h in hosts:
        h.shutdown()


# ---------------------------------------------------------------------------
# Data-parallel apps: deployment descriptions of the replica.

def build_llm_app(preset: Union[str, TransformerConfig] = "tiny", *,
                  params=None, name: Optional[str] = None,
                  min_replicas: int = 0, max_replicas: int = 4,
                  target_load: float = 4.0,
                  downscale_delay_s: float = 10.0,
                  max_batch: int = 4, max_len: int = 128,
                  page_size: int = 16, kv_pages: Optional[int] = None,
                  prefix_cache: bool = True, max_queue: int = 64,
                  max_tokens: int = 16, temperature: float = 0.0,
                  eos_id: Optional[int] = None, seed: int = 0,
                  num_cpus: float = 1.0, num_tpus: float = 0.0,
                  device: Union[str, torch.device] = "cuda"
                  ) -> serve.Application:
    """The reference's autoscaled continuous-batching app: replica count
    follows each replica's ``__serve_load__`` (admission queue depth x
    page-pool occupancy) between ``min_replicas`` (0 = scale-to-zero) and
    ``max_replicas``. A runtime that hosts it builds
    ``EngineReplica(*init_args, **init_kwargs)`` per replica and streams
    through its ``stream_generate``."""
    resolve_device(device)
    opts = {"num_cpus": num_cpus}
    if num_tpus:
        opts["resources"] = {"TPU": num_tpus}
    dep = serve.deployment(
        EngineReplica, name=name or f"llm-{preset}",
        ray_actor_options=opts,
        autoscaling_config={
            "min_replicas": min_replicas,
            "max_replicas": max_replicas,
            "target_ongoing_requests": target_load,
            "upscale_delay_s": 0.0,
            "downscale_delay_s": downscale_delay_s,
        })
    return dep.bind(preset, params=params, max_batch=max_batch,
                    max_len=max_len, page_size=page_size, kv_pages=kv_pages,
                    prefix_cache=prefix_cache, max_queue=max_queue,
                    max_tokens=max_tokens, temperature=temperature,
                    eos_id=eos_id, seed=seed, device=device)


def build_dp_deployment(preset: Union[str, TransformerConfig] = "tiny", *,
                        params=None, num_replicas: int = 1,
                        max_batch: int = 4, max_len: int = 128,
                        max_tokens: int = 16, temperature: float = 0.0,
                        eos_id: Optional[int] = None, seed: int = 0,
                        num_cpus: float = 1.0, num_tpus: float = 0.0,
                        prefix_cache: bool = True,
                        page_size: int = 16,
                        device: Union[str, torch.device] = "cuda"
                        ) -> serve.Application:
    """The reference's fixed-size data-parallel app: ``num_replicas``
    replicas, each a full continuous-batching engine (concurrent requests
    to one replica batch per decode tick)."""
    resolve_device(device)
    opts = {"num_cpus": num_cpus}
    if num_tpus:
        opts["resources"] = {"TPU": num_tpus}
    dep = serve.deployment(
        EngineReplica, name=f"llm-{preset}", num_replicas=num_replicas,
        ray_actor_options=opts)
    return dep.bind(preset, params=params, max_batch=max_batch,
                    max_len=max_len, max_tokens=max_tokens,
                    temperature=temperature, eos_id=eos_id, seed=seed,
                    prefix_cache=prefix_cache, page_size=page_size,
                    device=device)


# ---------------------------------------------------------------------------
# P/D disaggregation behind an ingress.

class _PDIngress:
    """Front door chaining prefill -> decode replicas (reference:
    pd_server.py PDProxyServer), each side round-robined over its hosts.

    ``direct=True`` (default): the prefill replica returns a HANDOFF whose
    ``ref`` is a ``HostRef`` to the blob in the prefill host's buffers;
    the decode replica resolves it onto its own device (one device-to-host
    copy and one upload of each tensor), and the buffer goes with that
    read. ``direct=False``: the blob travels by value, prefill -> ingress
    -> decode, the ingress materialising every byte in host memory on the
    way (the reference's two object-plane transfers).

    Either way the decode half enters the decode replica's admission queue
    (deadline-aware, shed-bounded) with the real prompt tokens, so its
    prefix cache learns the prompt. Hosted on a loop of its own, it reaches
    the replicas' loops through ``Hosted.acall``."""

    def __init__(self, prefill: Sequence[Hosted], decode: Sequence[Hosted],
                 direct: bool = True):
        self.prefill = list(prefill)
        self.decode = list(decode)
        self.direct = direct
        self._rr = itertools.count()

    def _pick(self):
        i = next(self._rr)
        return (self.prefill[i % len(self.prefill)],
                self.decode[i % len(self.decode)])

    async def __call__(self, prompt_tokens: Sequence[int],
                       max_tokens: int = 16, temperature: float = 0.0,
                       eos_id: Optional[int] = None) -> List[int]:
        opts = {"max_tokens": max_tokens, "temperature": temperature,
                "eos_id": eos_id}
        prompt = list(prompt_tokens)
        pre, dec = self._pick()
        if self.direct:
            handoff = await pre.acall(pre.replica.prefill_handoff(
                {"prompt": prompt, "opts": opts}))
            res = await dec.acall(dec.replica.decode_handoff(handoff))
        else:
            blob, first = await pre.acall(pre.replica.prefill(prompt, opts))
            dev = dec.replica.engine.device
            blob = _from_host(_to_host(blob, dev), dev)
            res = await dec.acall(dec.replica.decode(blob, first, opts,
                                                     prompt))
        return res["tokens"]

    def shutdown(self) -> None:
        _shutdown_all(self.prefill + self.decode)


def run_pd_app(preset: Union[str, TransformerConfig] = "tiny",
               params=None, *, prefill_replicas: int = 1,
               decode_replicas: int = 1, max_batch: int = 4,
               max_len: int = 128, seed: int = 0,
               prefix_cache: bool = True, direct: bool = True,
               name: Optional[str] = None,
               prefill_options: Optional[dict] = None,
               decode_options: Optional[dict] = None,
               device: Union[str, torch.device] = "cuda") -> Hosted:
    """Build the P/D app: prefill replicas (``max_batch=1``), decode
    replicas and the ingress, each hosted on a loop of its own. Returns the
    ingress's host: ``app.call(app.replica(prompt, max_tokens))`` gives the
    tokens; ``app.shutdown()`` shuts every host down. ``name`` is the
    reference's deployment tag; nothing is registered under it here."""
    del name
    place = _Placement(preset, params, seed, device)
    common = dict(max_len=max_len, seed=seed, prefix_cache=prefix_cache)
    hosts: List[Hosted] = []
    try:
        for n, options, kw in ((prefill_replicas, prefill_options,
                                dict(common, max_batch=1)),
                               (decode_replicas, decode_options,
                                dict(common, max_batch=max_batch))):
            dev = place.device_of(options)
            hosts += [_host_replica(place.cfg, place.params(dev), dev, **kw)
                      for _ in range(n)]
        return Hosted(_PDIngress(hosts[:prefill_replicas],
                                 hosts[prefill_replicas:], direct))
    except BaseException:
        _shutdown_all(hosts)
        raise


# ---------------------------------------------------------------------------
# P/D over fixed lanes.

class _Lane:
    """One prefill -> decode pair and the edge between them: the blob
    through the serializer into a host buffer and back onto the decode
    device (the compiled channel's rung 1), at most ``max_inflight``
    executions at a time."""

    def __init__(self, pre: Hosted, dec: Hosted, max_inflight: int):
        self.pre = pre
        self.dec = dec
        self.publish, self.resolve = _channel_callbacks(
            dec.replica.engine.device)
        self._inflight = threading.BoundedSemaphore(max(1, max_inflight))

    def execute(self, req: dict, timeout: float) -> int:
        """prefill_handoff_channel, the edge, then admit_external: the
        decode replica's request id."""
        if not self._inflight.acquire(timeout=timeout):
            raise TimeoutError(f"no free execution slot in {timeout} s")
        try:
            handoff = self.pre.call(
                self.pre.replica.prefill_handoff_channel(req), timeout)
            handoff["blob"] = self.resolve(self.publish(handoff["blob"]))
            return self.dec.call(self.dec.replica.admit_external(handoff),
                                 timeout)
        finally:
            self._inflight.release()


class CompiledPDApp:
    """P/D disaggregation over fixed lanes (reference: Ray LLM pd_server.py
    over a compiled two-stage DAG per lane)::

        (prompt, opts) -> prefill_handoff_channel -> edge -> admit_external

    N prefill and M decode replicas, each hosted on a loop of its own; one
    lane per ``max(N, M)`` pairs replica ``i % N`` with replica ``i % M``,
    and requests take the lanes round-robin. Admission is the lane's last
    stage: decode runs in the replica's continuous batch, so consecutive
    requests pipeline through prefill while earlier ones decode, and
    tokens stream back from the decode replica.

    Static by design: replica counts are fixed at build time."""

    def __init__(self, preset: Union[str, TransformerConfig] = "tiny",
                 params=None, *, prefill_replicas: int = 1,
                 decode_replicas: int = 1, max_batch: int = 4,
                 max_len: int = 128, page_size: int = 16, seed: int = 0,
                 prefix_cache: bool = True, max_queue: int = 64,
                 max_inflight: int = 8,
                 prefill_options: Optional[dict] = None,
                 decode_options: Optional[dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        place = _Placement(preset, params, seed, device)
        common = dict(max_len=max_len, page_size=page_size, seed=seed,
                      prefix_cache=prefix_cache, max_queue=max_queue)
        self.prefills: List[Hosted] = []
        self.decodes: List[Hosted] = []
        try:
            dev = place.device_of(prefill_options)
            for _ in range(prefill_replicas):
                self.prefills.append(_host_replica(
                    place.cfg, place.params(dev), dev, max_batch=1,
                    **common))
            dev = place.device_of(decode_options)
            for _ in range(decode_replicas):
                self.decodes.append(_host_replica(
                    place.cfg, place.params(dev), dev, max_batch=max_batch,
                    **common))
        except BaseException:
            self.shutdown()
            raise
        # More decode than prefill replicas (or vice versa) is the point of
        # disaggregation: the lanes cover every replica of the larger side.
        self._lanes = [
            _Lane(self.prefills[i % prefill_replicas],
                  self.decodes[i % decode_replicas], max_inflight)
            for i in range(max(prefill_replicas, decode_replicas))]
        self._rr = 0
        self._rr_lock = threading.Lock()
        self.num_replicas = decode_replicas

    def _next_lane(self) -> _Lane:
        with self._rr_lock:
            lane = self._lanes[self._rr % len(self._lanes)]
            self._rr += 1
        return lane

    def generate(self, prompt_tokens: Sequence[int],
                 opts: Optional[dict] = None,
                 timeout: float = 120.0) -> dict:
        """Blocking completion: {"tokens": [...], "finish_reason": ...}."""
        lane = self._next_lane()
        rid = lane.execute({"prompt": list(prompt_tokens),
                            "opts": opts or {}}, timeout)
        return lane.dec.call(lane.dec.replica.collect(rid), timeout)

    def stream(self, prompt_tokens: Sequence[int],
               opts: Optional[dict] = None, timeout: float = 120.0):
        """Generator of int tokens then one terminal dict — the
        run_open_loop submit contract."""
        lane = self._next_lane()
        rid = lane.execute({"prompt": list(prompt_tokens),
                            "opts": opts or {}}, timeout)
        yield from lane.dec.stream(lane.dec.replica.collect_stream(rid),
                                   timeout)

    def shutdown(self) -> None:
        _shutdown_all(self.prefills + self.decodes)


def run_pd_compiled(preset: Union[str, TransformerConfig] = "tiny",
                    **kwargs) -> CompiledPDApp:
    """Build the lane-based P/D deployment (see :class:`CompiledPDApp`)."""
    return CompiledPDApp(preset, **kwargs)


# ---------------------------------------------------------------------------
# Long context: sharded paged prefill, paged decode.

class LongContextApp:
    """Long-context serving: N prefill shards and decode replicas that hold
    less than the whole context.

    Prefill: the prompt is cut into ``span``-token chunks, round-robined
    over the shards. Chunk c's queries attend to the c parts published
    before it (ring order is the causal order, so the online-softmax
    accumulation is exact), pulled through the shard's gather window, and
    its own KV stripe is published into THAT shard's host buffers; only
    handles flow back. Each shard can run its intra-chunk attention
    sequence-parallel (``sp_degree`` > 1). The handoff is the union of
    every shard's stripes.

    Decode: ``EngineReplica.admit_paged``. The context stays in the
    shards' buffers; the decode replica streams attention over the parts
    through its window of ``kv_gather_window`` (a window smaller than the
    part count refetches, counted), and only the decode tail occupies its
    pool.

    Failure: a shard shut down mid-decode fails the affected streams typed
    (``StreamBrokenError`` carrying ``tokens_emitted``, ``KVGatherError``
    as its cause); pages and window state come back at once and other
    requests keep decoding."""

    def __init__(self, preset: Union[str, TransformerConfig] = "tiny",
                 params=None, *, prefill_shards: int = 2,
                 decode_replicas: int = 1, span: int = 64,
                 max_batch: int = 2, max_len: int = 128,
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 kv_gather_window: int = 4,
                 sp_degree: Optional[int] = None,
                 sp_strategy: str = "ring", max_tokens: int = 16,
                 seed: int = 0, prefill_options: Optional[dict] = None,
                 decode_options: Optional[dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        place = _Placement(preset, params, seed, device)
        self.span = int(span)
        common = dict(max_len=max_len, page_size=page_size,
                      kv_pages=kv_pages, prefix_cache=False,
                      kv_gather_window=kv_gather_window, seed=seed)
        self.shards: List[Hosted] = []
        self.decodes: List[Hosted] = []
        try:
            # Shards never admit decode requests: their pool only backs
            # scratch, so kv_pages can be tiny.
            dev = place.device_of(prefill_options)
            for _ in range(prefill_shards):
                self.shards.append(_host_replica(
                    place.cfg, place.params(dev), dev, max_batch=1,
                    sp_degree=sp_degree, sp_strategy=sp_strategy,
                    paged_span=span, **common))
            dev = place.device_of(decode_options)
            for _ in range(decode_replicas):
                self.decodes.append(_host_replica(
                    place.cfg, place.params(dev), dev, max_batch=max_batch,
                    max_tokens=max_tokens, **common))
        except BaseException:
            self.shutdown()
            raise
        self._rr = 0
        self._rr_lock = threading.Lock()
        self.num_replicas = decode_replicas

    def _next_decode(self) -> Hosted:
        with self._rr_lock:
            d = self.decodes[self._rr % len(self.decodes)]
            self._rr += 1
        return d

    def prefill(self, prompt_tokens: Sequence[int],
                opts: Optional[dict] = None,
                timeout: float = 120.0) -> dict:
        """Run the sharded paged prefill; returns the decode handoff
        ``{"parts": [{"span", "handle"}], "len", "first", "opts"}``. Chunks
        run in turn (chunk c attends to parts 0..c-1), their stripes stored
        in every shard's buffers."""
        prompt = list(prompt_tokens)
        S = len(prompt)
        n = max(1, -(-S // self.span))
        parts: List[dict] = []
        first = None
        for c in range(n):
            shard = self.shards[c % len(self.shards)]
            res = shard.call(shard.replica.prefill_paged_chunk({
                "chunk": prompt[c * self.span:(c + 1) * self.span],
                "pos0": c * self.span, "parts": parts,
                "span": self.span, "is_last": c == n - 1,
                "opts": opts or {}}), timeout)
            parts.append({"span": res["span"], "handle": res["handle"]})
            first = res.get("first", first)
        return {"parts": parts, "len": S, "first": int(first),
                "opts": opts or {}}

    def generate(self, prompt_tokens: Sequence[int],
                 opts: Optional[dict] = None,
                 timeout: float = 120.0) -> dict:
        """Blocking completion: {"tokens": [...], "finish_reason": ...}."""
        handoff = self.prefill(prompt_tokens, opts, timeout)
        dec = self._next_decode()
        return dec.call(dec.replica.decode_paged(handoff), timeout)

    def stream(self, prompt_tokens: Sequence[int],
               opts: Optional[dict] = None, timeout: float = 120.0):
        """Generator of int tokens then one terminal dict — the
        run_open_loop submit contract. Mid-decode KV loss raises
        StreamBrokenError out of the iteration, typed."""
        handoff = self.prefill(prompt_tokens, opts, timeout)
        dec = self._next_decode()
        rid = dec.call(dec.replica.admit_paged(handoff), timeout)
        yield from dec.stream(dec.replica.collect_stream(rid), timeout)

    def debug_stats(self, timeout: float = 30.0) -> dict:
        return {"shards": [s.debug_stats(timeout) for s in self.shards],
                "decodes": [d.debug_stats(timeout) for d in self.decodes]}

    def shutdown(self) -> None:
        _shutdown_all(self.shards + self.decodes)


def run_long_context_app(preset: Union[str, TransformerConfig] = "tiny",
                         **kwargs) -> LongContextApp:
    """Build the sharded long-context deployment (see
    :class:`LongContextApp`)."""
    return LongContextApp(preset, **kwargs)
