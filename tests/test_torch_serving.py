"""Parity of ray_tpu_torch's serving replica with the JAX package's on the
CPU.

Every script runs the same calls through the JAX ``EngineReplica`` (in
process, as tests/test_llm_serving.py:143-240 runs it) and the port's, each
on its own event loop. The JAX replica draws the ``tiny`` params from seed
0; the port's gets the same params converted (``from_jax_params``), in f32.
Tokens must be identical, typed errors of the same class with the same
message, the ``debug_stats()`` counters that do not depend on timing equal,
and the ``request``-category flight-recorder rows equal less their times.
"""

import asyncio
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu.exceptions as jax_exc
from ray_tpu._private import deadlines as jax_deadlines
from ray_tpu._private import flight_recorder as jax_flight_recorder
from ray_tpu.llm import EngineReplica as JaxReplica
from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.models import PRESETS as JAX_PRESETS
import ray_tpu_torch.exceptions as exc
from ray_tpu_torch._private import deadlines, flight_recorder
from ray_tpu_torch.llm import EngineReplica, LLMEngine, SamplingParams
from ray_tpu_torch.models import PRESETS, from_jax_params
from ray_tpu_torch.parallel import MeshSpec, build_mesh
from test_torch_flight_recorder import _captured, _spans

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
SIDES = (True, False)               # (JAX, port)
# debug_stats() keys whose values do not depend on timing.
EXACT_STATS = ("completed", "cancelled", "expired", "shed", "tokens_out",
               "kv_broken", "kv_pages_free", "kv_pages_total",
               "prefix_cache")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The JAX engine's seed-0 ``tiny`` params, as the port's tensors."""
    jeng = JaxEngine(JCFG, max_batch=1, max_len=64, seed=0)
    return from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG, "cpu")


@dataclasses.dataclass
class Side:
    """One package's replica class and the modules a script needs."""
    jax: bool
    params: dict

    @property
    def exc(self):
        return jax_exc if self.jax else exc

    @property
    def deadlines(self):
        return jax_deadlines if self.jax else deadlines

    def replica(self, cls=None, **kw):
        if self.jax:
            return (cls or JaxReplica)("tiny", **kw)
        return (cls or EngineReplica)(CFG, self.params, device="cpu", **kw)

    def engine(self, **kw):
        if self.jax:
            return JaxEngine(JCFG, seed=0, **kw)
        return LLMEngine(CFG, self.params, seed=0, device="cpu", **kw)

    def sp(self, **kw):
        return (JaxSP if self.jax else SamplingParams)(**kw)


def _both(params, script, *args):
    """script(side, *args) run on an event loop per side: [JAX's, port's]."""
    return [asyncio.run(script(Side(j, params), *args)) for j in SIDES]


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size,
                                                n).tolist()


def _stats_equal(jst, tst):
    """The same keys; the timing-free counters and the gather window's
    counters (less the wall-clock wait) equal."""
    assert set(tst) == set(jst)
    for key in EXACT_STATS:
        assert tst[key] == jst[key], key
    drop = ("wait_s",)
    assert ({k: v for k, v in tst["kv_gather"].items() if k not in drop}
            == {k: v for k, v in jst["kv_gather"].items() if k not in drop})


async def _consume(er, prompt, opts, *, take=None, started=None):
    """Stream ``prompt`` through ``er``: (tokens, finish_reason, arrival
    stamps). ``take`` abandons the stream after that many tokens;
    ``started`` (an asyncio.Event) is set at the second token."""
    toks, reason, stamps = [], None, []
    gen = er.stream_generate(prompt, opts)
    try:
        async for item in gen:
            if isinstance(item, dict):
                reason = item["finish_reason"]
                break
            stamps.append(time.monotonic())
            toks.append(item)
            if started is not None and len(toks) == 2:
                started.set()
            if take and len(toks) >= take:
                break
    finally:
        await gen.aclose()
    return toks, reason, stamps


# ------------------------------------------------------------- streaming ---

async def _streams_script(side):
    """tests/test_llm_serving.py:143-200: two overlapping streams, an
    abandoned one, and eos."""
    er = side.replica(max_batch=4, max_len=64, page_size=8, max_tokens=16)
    opts = {"max_tokens": 16}

    started = asyncio.Event()

    async def late_arrival():
        # Arrives while the first request is decoding (its second token is
        # out), whatever the speed of a tick.
        await started.wait()
        return await _consume(er, [9, 8, 7], opts)

    (ta, ra, sa), (tb, rb, sb) = await asyncio.gather(
        _consume(er, [1, 2, 3, 4, 5], opts, started=started),
        late_arrival())
    assert ra == rb == "length" and len(ta) == len(tb) == 16
    assert sa[0] < sa[-1] and sb[0] < sb[-1]         # incremental arrival
    st = await er.debug_stats()
    assert st["max_active"] >= 2, st                 # batched concurrently
    ref = side.engine(max_batch=4, max_len=64)
    assert ta == ref.generate([[1, 2, 3, 4, 5]], side.sp(max_tokens=16))[0]

    # abandoned stream -> typed cancel, pages freed mid-decode
    await _consume(er, [11, 12, 13], opts, take=3)
    await asyncio.sleep(0.3)
    st = await er.debug_stats()
    assert st["cancelled"] >= 1, st
    assert st["kv_pages_free"] == st["kv_pages_total"], st
    assert st["active"] == 0 and st["queue_depth"] == 0

    # eos -> finish_reason "stop"
    free_run, _, _ = await _consume(er, [3, 17, 42], opts)
    eos = free_run[2]
    toks, reason, _ = await _consume(er, [3, 17, 42],
                                     {"max_tokens": 16, "eos_id": eos})
    assert reason == "stop" and toks == free_run[:3]
    return dict(a=ta, b=tb, eos=(toks, reason), free=free_run,
                stats=await er.debug_stats(),
                generate=await er.generate([4, 4, 2], opts),
                call=await er([4, 4, 2], opts))


def test_replica_streams_batches_and_cancels_as_jax(params):
    """The port of test_engine_replica_streams_batches_and_cancels: both
    replicas stream the JAX closed-loop engine's tokens, batch a late
    arrival, cancel an abandoned stream with every page back, and stop on
    eos."""
    want, got = _both(params, _streams_script)
    _stats_equal(want.pop("stats"), got.pop("stats"))
    assert got == want
    assert got["call"] == got["generate"]["tokens"]


async def _deadline_script(side):
    """tests/test_llm_serving.py:202-240: a request queued behind a full
    pool expires typed without occupying a slot."""
    er = side.replica(max_batch=2, max_len=512, page_size=16, kv_pages=31,
                      max_tokens=480, max_queue=16)
    started = asyncio.Event()
    long_task = asyncio.ensure_future(
        _consume(er, [1, 2, 3], {"max_tokens": 480}, started=started))
    # Its first tick is over (two tokens out; on the JAX side it compiled):
    # the pool is exhausted and the ticks left are short. Waiting on the
    # event, not a fixed sleep, keeps a slow first tick (under load) from
    # racing the deadline below.
    await started.wait()
    assert (await er.debug_stats())["kv_pages_free"] == 0
    tok = side.deadlines.set_current(time.time() + 0.2)
    try:
        with pytest.raises(side.exc.DeadlineExceededError,
                           match="queue") as ei:
            await _consume(er, [7, 8, 9], {"max_tokens": 4})
    finally:
        side.deadlines.reset(tok)
    long_toks, reason, _ = await long_task
    assert len(long_toks) == 480 and reason == "length"
    st = await er.debug_stats()
    assert st["expired"] == 1 and st["kv_pages_free"] == 31
    return dict(err=str(ei.value), long=long_toks, stats=st)


def test_queued_deadline_expires_typed_as_jax(params):
    want, got = _both(params, _deadline_script)
    _stats_equal(want.pop("stats"), got.pop("stats"))
    assert got == want
    assert got["err"] == "deadline exceeded in serving admission queue"


async def _shed_script(side):
    """Against one slot: with two requests queued (the decode loop has not
    ticked yet), a deadline closer than the estimated wait sheds on the
    deadline-aware bound and one already past expires; then four more
    arrivals meet max_queue=4 after the first tick, and the last sheds on
    the absolute bound."""
    er = side.replica(max_batch=1, max_len=64, page_size=8, kv_pages=8,
                      max_tokens=12, max_queue=4)
    E = side.exc

    def arrive(i):
        return asyncio.ensure_future(
            _consume(er, [i + 1, i + 2, i + 3], {"max_tokens": 12}))

    async def with_deadline(delta):
        tok = side.deadlines.set_current(time.time() + delta)
        try:
            await _consume(er, [5, 6, 7], {"max_tokens": 2})
        except (E.OverloadedError, E.DeadlineExceededError) as e:
            return e
        finally:
            side.deadlines.reset(tok)

    good = [arrive(0), arrive(1)]
    await asyncio.sleep(0)          # both enqueue; no tick has run
    # A shed or expired arrival never awaits, so the queue still holds 2
    # and the estimated wait is 2 x 0.25 s (no request has completed).
    errors = []
    e = await with_deadline(0.3)
    assert type(e) is E.OverloadedError and e.retry_after_s > 0
    errors.append((type(e).__name__, str(e), e.retry_after_s))
    e = await with_deadline(-1.0)
    assert type(e) is E.DeadlineExceededError
    errors.append((type(e).__name__, str(e), None))
    # The decode loop takes the (FIFO) lock first: after its first tick one
    # request is admitted, and these find 1, 2, 3 and then 4 queued.
    late = [arrive(i) for i in range(2, 6)]
    while not late[-1].done():
        await asyncio.sleep(0.001)
    e = late.pop().exception()
    assert type(e) is E.OverloadedError and e.retry_after_s > 0
    errors.append((type(e).__name__, str(e), e.retry_after_s))
    for fn, arg in (("prefill", [1, 2, 3]),
                    ("prefill_handoff", {"prompt": [1, 2, 3]}),
                    ("prefill_handoff_channel", {"prompt": [1, 2, 3]}),
                    ("prefill_paged_handoff", {"prompt": [1, 2, 3]}),
                    ("prefill_paged_chunk", {"chunk": [1, 2], "pos0": 0})):
        tok = side.deadlines.set_current(time.time() - 1.0)
        try:
            with pytest.raises(E.DeadlineExceededError) as ei:
                await getattr(er, fn)(arg)
        finally:
            side.deadlines.reset(tok)
        errors.append((fn, str(ei.value)))
    with pytest.raises(E.RayError, match="unknown or already-collected"):
        async for _ in er.collect_stream(12345):
            pass
    outs = [(await t)[0] for t in good + late]
    st = await er.debug_stats()
    assert (st["shed"], st["expired"], st["completed"]) == (2, 1, 5)
    return dict(errors=errors, outs=outs, stats=st)


def test_shedding_and_expiry_match_jax(params):
    """Both bounds shed typed with JAX's messages and retry_after_s; a
    deadline already past expires; every prefill refuses an expired
    deadline; the counters equal JAX's."""
    want, got = _both(params, _shed_script)
    _stats_equal(want.pop("stats"), got.pop("stats"))
    assert got == want
    assert got["errors"][0][1].startswith("estimated queue wait 0.50s")
    assert got["errors"][2][1] == "admission queue full (4 >= 4)"


# ------------------------------------------------------- P/D and paged KV ---

PD = dict(max_batch=2, max_len=64, page_size=8, max_tokens=6)


async def _pd_reference(side, prompt):
    """JAX's route: prefill_handoff_channel -> decode_handoff."""
    p, d = side.replica(**PD), side.replica(**PD)
    h = await p.prefill_handoff_channel({"prompt": prompt})
    return (await d.decode_handoff(h))["tokens"]


async def _pd_routes(side, prompt):
    """Every P/D route of the port's replica, on one prefill and one decode
    replica; publish/resolve through a store for the last one."""
    store = {}

    def publish(x):
        store[f"h{len(store)}"] = x
        return f"h{len(store) - 1}"

    async def resolve(ref):
        await asyncio.sleep(0)
        return store.pop(ref)

    p, d = side.replica(**PD), side.replica(**PD)
    out = {}
    h = await p.prefill_handoff_channel({"prompt": prompt})
    out["channel"] = (await d.decode_handoff(h))["tokens"]
    h = await p.prefill_handoff({"prompt": prompt})
    assert h["ref"]["len"] == len(prompt)          # by value by default
    out["handoff"] = (await d.decode_handoff(h))["tokens"]
    blob, first = await p.prefill(prompt)
    out["decode"] = (await d.decode(blob, first,
                                    prompt_tokens=prompt))["tokens"]
    h = await p.prefill_handoff_channel({"prompt": prompt})
    rid = await d.admit_external(h)
    items = [item async for item in d.collect_stream(rid)]
    assert items[-1] == {"finish_reason": "length", "n_tokens": 6}
    out["admit_external"] = items[:-1]
    pc, dc = side.replica(publish=publish, **PD), \
        side.replica(resolve=resolve, **PD)
    h = await pc.prefill_handoff({"prompt": prompt})
    assert isinstance(h["ref"], str)
    out["callbacks"] = (await dc.decode_handoff(h))["tokens"]
    assert not store
    st = await d.debug_stats()
    assert st["kv_pages_free"] + st["prefix_cache"]["allocated_pages"] \
        == st["kv_pages_total"] and st["active"] == 0
    return out


def test_pd_routes_match_jax(params):
    """prefill_handoff_channel, prefill_handoff (default publish and
    resolve, and callbacks), prefill -> decode and admit_external +
    collect_stream each give the JAX replica's channel-route tokens."""
    prompt = _prompt(21, seed=5)
    want = asyncio.run(_pd_reference(Side(True, params), prompt))
    got = asyncio.run(_pd_routes(Side(False, params), prompt))
    assert len(want) == 6
    assert got == {k: want for k in got}


PAGED = dict(max_batch=1, max_len=64, page_size=16, kv_pages=4,
             kv_gather_window=8, max_tokens=5)
PAGED_LEN, PAGED_SPAN = 70, 16          # 5 parts; the window holds them all


async def _paged_reference(side, prompt):
    """JAX's route: the engine's by-value prefill_paged handoff through
    the replica's admit_paged + collect_stream."""
    h = side.engine(**{k: v for k, v in PAGED.items()
                       if k != "max_tokens"}).prefill_paged(
        prompt, side.sp(max_tokens=5), span=PAGED_SPAN)
    d = side.replica(**PAGED)
    rid = await d.admit_paged(h)
    items = [item async for item in d.collect_stream(rid)]
    return h["first"], items


async def _paged_routes(side, prompt):
    p, d = side.replica(**PAGED), side.replica(**PAGED)
    out = {}
    h = await p.prefill_paged_handoff({"prompt": prompt,
                                       "span": PAGED_SPAN})
    assert len(h["parts"]) == 5 and h["len"] == PAGED_LEN
    out["decode_paged"] = (await d.decode_paged(h))["tokens"]
    rid = await d.admit_paged(h)
    out["admit_paged"] = [item async for item in d.collect_stream(rid)]
    # The sequence-parallel shard's unit: one chunk at a time, each
    # attending to the parts before it; the last samples the first token.
    parts, first = [], None
    for s0 in range(0, PAGED_LEN, PAGED_SPAN):
        part = await p.prefill_paged_chunk({
            "chunk": prompt[s0:s0 + PAGED_SPAN], "pos0": s0,
            "parts": parts, "span": PAGED_SPAN,
            "is_last": s0 + PAGED_SPAN >= PAGED_LEN})
        first = part.pop("first", first)
        parts.append(part)
    out["chunks_first"] = first
    out["chunks"] = (await d.decode_paged(
        {"parts": parts, "len": PAGED_LEN, "first": first}))["tokens"]
    st = await d.debug_stats()
    assert st["kv_pages_free"] == st["kv_pages_total"]
    assert st["kv_gather"]["resident"] == 0
    assert st["kv_gather"]["refetches"] == 0
    return out


def test_paged_routes_match_jax(params):
    """prefill_paged_handoff -> decode_paged, admit_paged +
    collect_stream, and a chain of prefill_paged_chunk calls give the JAX
    replica's admit_paged tokens of the JAX engine's by-value handoff."""
    prompt = _prompt(PAGED_LEN, seed=6)
    first, items = asyncio.run(_paged_reference(Side(True, params), prompt))
    got = asyncio.run(_paged_routes(Side(False, params), prompt))
    toks = items[:-1]
    assert items[-1] == {"finish_reason": "length", "n_tokens": 5}
    assert got["decode_paged"] == got["chunks"] == toks and toks[0] == first
    assert got["admit_paged"] == items and got["chunks_first"] == first


class _FailingFetch:
    """A KV-part fetch that raises ConnectionError from its ``fail_at``-th
    call on (thread-safe: the gather pool calls it too)."""

    def __init__(self, parts, fail_at):
        self.parts, self.fail_at = parts, fail_at
        self.calls = 0
        self._lock = threading.Lock()

    def __call__(self, handle):
        with self._lock:
            self.calls += 1
            if self.calls >= self.fail_at:
                raise ConnectionError("the KV parts' holder is gone")
        return self.parts[handle]


class _JaxFetchReplica(JaxReplica):
    """The JAX replica with its object-plane get replaced by a fetch
    callable, for both the blocking fetch and the gather pool's warm."""

    fetch = None

    def _kv_fetch(self, handle):
        if isinstance(handle, dict):
            return handle
        return self.fetch(handle)

    def _kv_prefetch(self, handle):
        if isinstance(handle, dict):
            return super()._kv_prefetch(handle)
        return self._fetch_pool.submit(self._kv_fetch, handle)


BROKEN_LEN, BROKEN_SPAN = 32, 16        # 2 parts through a window of 1
# Each decode token gathers 2 parts in each of tiny's 2 layers (window 1:
# every layer refetches): 4 calls. The 9th fails the third decode step.
FAIL_AT = 9


async def _kv_broken_script(side, prompt):
    """A paged request whose parts' holder is lost mid-decode fails typed;
    the replica then serves a fresh request."""
    h = side.engine(max_batch=1, max_len=64, page_size=16).prefill_paged(
        prompt, side.sp(max_tokens=8), span=BROKEN_SPAN)
    parts = {f"part{i}": p["handle"] for i, p in enumerate(h["parts"])}
    fetch = _FailingFetch(parts, FAIL_AT)
    kw = dict(max_batch=1, max_len=64, page_size=16, kv_pages=4,
              kv_gather_window=1, max_tokens=8)
    if side.jax:
        cls = type("Replica", (_JaxFetchReplica,), {"fetch": fetch})
        d = side.replica(cls, **kw)
    else:
        d = side.replica(kv_fetch=fetch, **kw)
    handoff = {"parts": [{"span": p["span"], "handle": f"part{i}"}
                         for i, p in enumerate(h["parts"])],
               "len": h["len"], "first": h["first"]}
    with pytest.raises(side.exc.StreamBrokenError) as ei:
        await d.decode_paged(handoff)
    err = ei.value
    assert isinstance(err.__cause__, side.exc.KVGatherError)
    assert isinstance(err.__cause__.__cause__, ConnectionError)
    st = await d.debug_stats()
    assert st["kv_broken"] == 1 and st["active"] == 0
    assert st["kv_pages_free"] == st["kv_pages_total"]
    assert st["kv_gather"]["resident"] == 0
    fresh = await d.generate(_prompt(5, seed=14), {"max_tokens": 3})
    assert len(fresh["tokens"]) == 3
    return dict(tokens_emitted=err.tokens_emitted, msg=str(err),
                calls=fetch.calls, fresh=fresh,
                stats=await d.debug_stats())


def test_kv_loss_mid_decode_breaks_the_stream_as_jax(params):
    """A kv_fetch that raises ConnectionError on its 9th call gives
    StreamBrokenError from decode_paged with JAX's tokens_emitted, a
    KVGatherError cause, kv_broken 1, every page and window slot free,
    and a fresh request served after."""
    prompt = _prompt(BROKEN_LEN, seed=7)
    want, got = _both(params, _kv_broken_script, prompt)
    _stats_equal(want.pop("stats"), got.pop("stats"))
    assert got == want
    assert got["tokens_emitted"] == 3


# --------------------------------------------------------------- spans ---

async def _span_script(side, prompt):
    """Three streams into two slots, the third abandoned after two tokens,
    then a paged request whose parts are lost mid-decode."""
    er = side.replica(max_batch=2, max_len=64, page_size=8)
    outs = await asyncio.gather(
        _consume(er, [1, 2, 3], {"max_tokens": 4}),
        _consume(er, [4, 5, 6, 7], {"max_tokens": 6}),
        _consume(er, [8, 9], {"max_tokens": 8}, take=2))
    await asyncio.sleep(0.1)
    return [o[0] for o in outs], await _kv_broken_script(side, prompt)


def test_request_spans_and_instants_match_jax(params):
    """request:admit spans (with queued and decoding), the
    request:cancelled and request:kv_broken instants and the engine's
    spans, in order, with ids and args equal to JAX's. Captured as in
    tests/test_torch_flight_recorder.py: the JAX capture takes only the
    ``request`` category."""
    prompt = _prompt(BROKEN_LEN, seed=7)
    runs = []
    for jax_side in SIDES:
        with _captured(jax_flight_recorder, categories={"request"}) \
                as jrec, \
                _captured(flight_recorder) as trec:
            outs, broken = asyncio.run(
                _span_script(Side(jax_side, params), prompt))
            rows = (jrec if jax_side else trec).rows()
        broken.pop("stats")
        runs.append((outs, broken, _spans(rows)))
    assert runs[1] == runs[0]
    spans = runs[1][2]
    admits = [(i, a) for _, n, i, a in spans if n == "request:admit"]
    ids = [i.to_bytes(8, "little") for i in range(3)]
    # Tick 1 admits the first two with the third queued; the third is
    # admitted once the first retires; then the paged and fresh requests.
    assert admits[:3] == [(ids[0], {"queued": 1, "decoding": 1}),
                          (ids[1], {"queued": 1, "decoding": 1}),
                          (ids[2], {"queued": 0, "decoding": 1})]
    assert len(admits) == 5
    instants = [(n, i, a) for _, n, i, a in spans
                if n in ("request:cancelled", "request:kv_broken")]
    assert instants == [("request:cancelled", ids[2], {}),
                        ("request:kv_broken", ids[0], {"tokens": 3})]


# ------------------------------------------------------ surface and faults ---

def test_a_failed_tick_fails_its_streams_where_jax_retries(params):
    """A decode tick that raises: the port raises it to every in-flight
    consumer and refuses new requests; the JAX replica logs it and retries
    every 0.2 s, so the stream waits with no error (ROADMAP Queue 3)."""

    async def script(side):
        er = side.replica(max_batch=1, max_len=64, page_size=8)

        def broken_step():
            raise RuntimeError("kernel launch failed")
        er.engine.step = broken_step
        gen = er.stream_generate([1, 2, 3], {"max_tokens": 4})
        try:
            first = await asyncio.wait_for(gen.__anext__(), 1.0)
        except (RuntimeError, asyncio.TimeoutError) as e:
            first = e
        finally:
            await gen.aclose()
        if side.jax:
            return first
        with pytest.raises(exc.RayError, match="serves no more") as ei:
            await er.generate([1, 2, 3])
        assert isinstance(ei.value.__cause__, RuntimeError)
        with pytest.raises(exc.RayError, match="serves no more"):
            await er.prefill([1, 2, 3])
        return first

    jax_first, port_first = _both(params, script)
    assert isinstance(jax_first, asyncio.TimeoutError)
    assert isinstance(port_first, RuntimeError)
    assert str(port_first) == "kernel launch failed"


def _missing_v(blob):
    return {"k": blob["k"], "len": blob["len"]}


def _short_k(blob):
    return dict(blob, k=blob["k"][:, :-1])


def _int_v(blob):
    return dict(blob, v=blob["v"].to(torch.int32))


@pytest.mark.parametrize("spoil", [_missing_v, _short_k, _int_v])
def test_a_malformed_handoff_fails_only_its_caller(params, spoil):
    """A KV blob with a missing key, a wrong shape or an integer dtype is
    refused at enqueue, to its own caller, through decode and
    decode_handoff alike; an in-flight stream beside it is unharmed and the
    replica serves a good handoff after (its tick is never reached)."""
    prompt = _prompt(21, seed=5)

    async def script():
        p = EngineReplica(CFG, params, device="cpu", **PD)
        d = EngineReplica(CFG, params, device="cpu", **PD)
        h = await p.prefill_handoff_channel({"prompt": prompt})
        bad = spoil(h["blob"])
        beside = asyncio.ensure_future(d.generate(_prompt(9, seed=6)))
        with pytest.raises(ValueError, match="kv blob"):
            await d.decode(bad, h["first"], prompt_tokens=prompt)
        with pytest.raises(ValueError, match="kv blob"):
            await d.decode_handoff(dict(h, blob=bad))
        with pytest.raises(ValueError, match="kv blob"):
            await d.admit_external(dict(h, blob=bad))
        other = await beside
        good = await d.decode_handoff(h)
        st = await d.debug_stats()
        assert d._failed is None and st["active"] == 0
        assert st["completed"] == 2 and st["queue_depth"] == 0
        return other, good

    other, good = asyncio.run(script())
    assert len(other["tokens"]) == 6 and len(good["tokens"]) == 6
    want = asyncio.run(_pd_reference(Side(True, params), prompt))
    assert good["tokens"] == want


def test_replica_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineReplica("tiny")


def test_unported_replica_options_are_absent(params):
    """mesh, sp_degree and sp_strategy reach the engine (their parity is in
    tests/test_torch_sp_prefill.py); a mesh with an axis other than sp
    larger than 1 still raises NotImplementedError, as in the engine."""
    er = EngineReplica(CFG, params, device="cpu", sp_degree=2,
                       sp_strategy="ulysses")
    assert (er.engine.sp_degree, er.engine.sp_strategy) == (2, "ulysses")
    for spec in (dict(tp=2), dict(dp=2, sp=2)):
        mesh = build_mesh(MeshSpec(**spec),
                          devices=["cpu"] * MeshSpec(**spec).n_devices)
        with pytest.raises(NotImplementedError, match="item 4"):
            EngineReplica(CFG, params, device="cpu", mesh=mesh)


def test_replica_uses_given_params_and_serves_load(params):
    """params are used as they are (no copy); a preset name and a config
    select the same model; __serve_load__ reads 0 when idle."""
    er = EngineReplica("tiny", params, device="cpu")
    assert er.engine.params is params and er.engine.cfg == CFG
    assert er.__serve_load__() == 0.0
    assert EngineReplica(CFG, params, device="cpu").engine.params is params
    assert asyncio.run(er.pid()) > 0
