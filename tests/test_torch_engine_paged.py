"""Parity of ray_tpu_torch's paged external requests with the JAX engine on
the CPU.

The ports of tests/test_long_context.py:201-291, each run on both engines:
the JAX engine's ``tiny`` params (f32) are carried across, and tokens, tick
events, page accounting and ``kv_gather_stats()`` (less the wall-clock
``wait_s``) must be identical after the same calls. Beside them: the
handoff of ``prefill_paged`` against JAX's, the shared ValueError messages,
a paged request cancelled mid-decode, and the host-staged downgrade
(``host_staged=True``) with the copy audit it feeds, against JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ray_tpu._private import device_plane as jdp
from ray_tpu.exceptions import KVGatherError as JaxKVGatherError
from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.llm.engine import _KVWindow as JaxKVWindow
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu_torch._private import device_plane as tdp
from ray_tpu_torch.exceptions import KVGatherError
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.llm.engine import _KVWindow
from ray_tpu_torch.models import PRESETS, from_jax_params

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
PAGED = dict(max_batch=1, max_len=64, page_size=16, kv_pages=4, seed=0)


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


def _engines(params, **kw):
    """(JAX engine, port engine) over the same params; the JAX engine draws
    them from the same seed."""
    return (JaxEngine(JCFG, **kw),
            LLMEngine(CFG, params, device="cpu", **kw))


def _sp(eng, **kw):
    return (JaxSP if isinstance(eng, JaxEngine) else SamplingParams)(**kw)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size,
                                                n).tolist()


def _gather_stats(eng):
    st = dict(eng.kv_gather_stats())
    del st["wait_s"]                    # wall clock
    return st


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ------------------------------------------------ the reference's tests ---

def test_paged_prefill_decode_parity_and_accounting(params):
    """prefill_paged -> decode_paged on engines whose max_len (64) is below
    the context (100): the tokens equal JAX's and the closed-loop engine's,
    only the decode tail takes pool pages, and the window (2) smaller than
    the part count (4) refetches, counted the same on both sides."""
    prompt = _prompt(100, seed=5)
    results = []
    for cls in (JaxEngine, LLMEngine):
        kw = {} if cls is JaxEngine else dict(params=params, device="cpu")
        cfg = JCFG if cls is JaxEngine else CFG
        base = cls(cfg, max_batch=1, max_len=256, seed=0, **kw)
        sp = _sp(base, max_tokens=6)
        expect = base.generate([prompt], sp)[0]
        pre = cls(cfg, **PAGED, **kw)
        dec = cls(cfg, kv_gather_window=2, **PAGED, **kw)
        handoff = pre.prefill_paged(prompt, sp, span=32)
        assert len(handoff["parts"]) == 4 and handoff["len"] == 100
        out = dec.decode_paged(handoff, sp)
        assert out == expect
        results.append((out, dec.kv_pages_free(), dec.kv_pages_total,
                        _gather_stats(dec), _gather_stats(pre)))
    assert results[1] == results[0]
    _, free, total, st, _ = results[1]
    assert free == total                           # no page leaked
    assert st["resident"] == 0 and st["fetches"] > 0
    assert st["refetches"] > 0                     # window 2 < 4 parts


@pytest.mark.parametrize("window,error", [(_KVWindow, KVGatherError),
                                          (JaxKVWindow, JaxKVGatherError)])
def test_kv_window_refetch_counting_and_typed_failure(window, error):
    calls = []

    def fetch(handle):
        calls.append(handle)
        if handle == "boom":
            raise OSError("holder died")
        return {"k": np.zeros(2), "v": np.zeros(2), "len": 2}

    w = window(1, fetch)
    w.get("a", "ha")
    w.get("b", "hb")                  # evicts a
    w.get("a", "ha")                  # fetched again: counted
    assert w.fetches == 3 and w.refetches == 1
    assert calls == ["ha", "hb", "ha"]
    with pytest.raises(error) as ei:
        w.get("c", "boom")
    assert isinstance(ei.value.__cause__, OSError)
    assert "OSError: holder died" in str(ei.value)
    # A malformed payload is typed too, not an AttributeError later.
    with pytest.raises(error, match="expected"):
        window(1, lambda h: "junk").get("x", "hx")
    st = w.stats()
    assert (st["fetches"], st["refetches"], st["bytes"], st["resident"],
            st["capacity"]) == (3, 1, 96, 1, 1)


def test_kv_window_prefetch_and_drop_match_jax():
    """Prefetched parts come from their futures, a failed future is typed,
    and drop() forgets keys (no refetch counted after), on both windows."""
    from concurrent.futures import Future

    def done(value=None, exc=None):
        f = Future()
        f.set_exception(exc) if exc else f.set_result(value)
        return f

    logs = []
    for window, error in ((JaxKVWindow, JaxKVGatherError),
                          (_KVWindow, KVGatherError)):
        part = {"k": np.ones((2, 3), np.float32),
                "v": np.ones((2, 3), np.float32), "len": 3}
        prefetched = []

        def prefetch(h):
            prefetched.append(h)
            if h == "bad":
                return done(exc=ConnectionError("gone"))
            return done(part)
        w = window(2, lambda h: part, prefetch)
        w.prefetch([("a", "ha"), ("b", "bad")])
        w.prefetch([("a", "ha")])         # pending: not started twice
        got = w.get("a", "ha")
        with pytest.raises(error) as ei:
            w.get("b", "bad")
        assert isinstance(ei.value.__cause__, ConnectionError)
        w.drop(["a"])
        w.get("a", "ha")                  # forgotten: not a refetch
        logs.append((prefetched, got["len"], w.fetches, w.refetches,
                     w.bytes_fetched, len(w._data)))
    assert logs[1] == logs[0] == (["ha", "bad"], 3, 2, 0, 96, 1)


def test_paged_decode_gather_failure_is_typed_and_leak_free(params):
    """The holder of a part dies mid-decode: the paged request retires
    typed (finish_reason "error", KVGatherError caused by the
    ConnectionError), the colocated pool request decodes to completion with
    the tick events of JAX's, and every page and window slot is free."""
    prompt = _prompt(64, seed=6)
    runs = []
    for jax_side in (True, False):
        cls = JaxEngine if jax_side else LLMEngine
        kw = {} if jax_side else dict(params=params, device="cpu")
        cfg = JCFG if jax_side else CFG
        pre = cls(cfg, **PAGED, **kw)
        sp = _sp(pre, max_tokens=8)
        handoff = pre.prefill_paged(prompt, sp, span=32)
        alive = {"ok": True}

        def fetch(handle):
            if not alive["ok"]:
                raise ConnectionError("KV holder died")
            return handle

        dec = cls(cfg, max_batch=2, max_len=64, page_size=16, kv_pages=6,
                  seed=0, kv_gather_window=1, kv_fetch=fetch, **kw)
        rid = dec.add_paged_request(handoff["parts"], handoff["len"],
                                    handoff["first"], sp)
        other = dec.add_request(_prompt(5, seed=8),
                                _sp(dec, max_tokens=12))
        events = []
        dec.step()                        # both admitted; both emit
        events += dec.take_tick_events()
        dec.step()
        events += dec.take_tick_events()
        alive["ok"] = False               # the holding host dies
        finished = {}
        while dec.has_unfinished():
            for done in dec.step():
                finished[done.req_id] = done
            events += dec.take_tick_events()
        err = finished[rid]
        assert err.finish_reason == "error"
        assert isinstance(err.error, JaxKVGatherError if jax_side
                          else KVGatherError)
        assert isinstance(err.error.__cause__, ConnectionError)
        assert finished[other].finish_reason == "length"
        assert len(dec._requests) == 0
        runs.append((events, [finished[r].out for r in (rid, other)],
                     dec.kv_pages_free(), dec.kv_pages_total,
                     _gather_stats(dec)))
    assert runs[1] == runs[0]
    events, (paged_out, other_out), free, total, st = runs[1]
    assert len(other_out) == 12 and free == total and st["resident"] == 0
    # The first token at admission and one decode token in each of the two
    # steps before the holder died.
    assert len(paged_out) == 3


# ---------------------------------------------------------- beside them ---

def test_prefill_paged_handoff_matches_jax(params):
    """The handoff's spans, lengths and first token equal JAX's and its
    parts' k/v agree within 1e-5; publish with and without the pipeline
    gives the same handoff."""
    prompt = _prompt(90, seed=11)
    jeng = JaxEngine(JCFG, **PAGED)
    teng = LLMEngine(CFG, params, device="cpu", **PAGED)
    want = jeng.prefill_paged(prompt, JaxSP(max_tokens=4), span=32)
    got = teng.prefill_paged(prompt, SamplingParams(max_tokens=4), span=32)
    assert got["len"] == want["len"] == 90
    assert got["first"] == want["first"]
    assert [p["span"] for p in got["parts"]] \
        == [p["span"] for p in want["parts"]] == [(0, 32), (32, 64),
                                                  (64, 90)]
    for g, w in zip(got["parts"], want["parts"]):
        assert g["handle"]["len"] == w["handle"]["len"]
        for name in ("k", "v"):
            t = g["handle"][name]
            assert tuple(t.shape) == (CFG.num_layers, 32, CFG.num_kv_heads,
                                      CFG.head_dim_)
            np.testing.assert_allclose(_np(t), _np(w["handle"][name]),
                                       rtol=1e-5, atol=1e-5)
    published = []

    def publish(part):
        published.append(part["len"])
        return {"k": part["k"].clone(), "v": part["v"].clone(),
                "len": part["len"]}
    handoffs = [teng.prefill_paged(prompt, SamplingParams(max_tokens=4),
                                   span=32, publish=publish, pipeline=p)
                for p in (True, False)]
    assert published == [32, 32, 26] * 2
    for h in handoffs:
        assert (h["len"], h["first"]) == (got["len"], got["first"])
        for a, b in zip(h["parts"], got["parts"]):
            assert a["span"] == b["span"]
            assert a["handle"]["len"] == b["handle"]["len"]
            for name in ("k", "v"):
                assert a["handle"][name].device.type == "cpu"
                assert torch.equal(a["handle"][name], b["handle"][name])


def test_pipelined_prefill_with_a_small_window_fails_as_jax_does(params):
    """A pipelined prefill whose window holds fewer parts than it makes
    must read an early part through its handle, an unresolved future, and
    fails typed on both engines (the reference's behaviour, kept)."""
    prompt = _prompt(100, seed=12)
    errors = []
    for jeng_side, error in ((True, JaxKVGatherError), (False, KVGatherError)):
        eng = (JaxEngine(JCFG, kv_gather_window=2, **PAGED) if jeng_side
               else LLMEngine(CFG, params, device="cpu", kv_gather_window=2,
                              **PAGED))
        with pytest.raises(error, match="Future needs a kv_fetch") as ei:
            eng.prefill_paged(prompt, _sp(eng, max_tokens=4), span=32,
                              publish=lambda part: part, pipeline=True)
        errors.append(str(ei.value).split(" callback")[0])
    assert errors[1] == errors[0]


def _value_errors(eng, sp):
    good = {"k": np.zeros((2, 8, 4, 16), np.float32),
            "v": np.zeros((2, 8, 4, 16), np.float32), "len": 8}
    calls = [
        lambda: eng._norm_parts([{"span": (0, 8), "handle": good},
                                 {"span": (9, 16), "handle": good}], 16, "t"),
        lambda: eng._norm_parts([{"span": (0, 8), "handle": good},
                                 {"span": (8, 8), "handle": good}], 16, "t"),
        lambda: eng._norm_parts([{"span": (0, 8), "handle": good}], 16, "t"),
        lambda: eng.prefill_paged_chunk([], 0, [], span=8, is_last=True),
        lambda: eng.prefill_paged_chunk(list(range(1, 10)), 0, [], span=8,
                                        is_last=True),
        lambda: eng.add_paged_request([{"span": (0, 8), "handle": good}], 8,
                                      1, sp(max_tokens=80)),
        lambda: eng.add_paged_request([{"span": (0, 8), "handle": good}], 9,
                                      1, sp(max_tokens=4)),
    ]
    out = []
    for call in calls:
        with pytest.raises(ValueError) as ei:
            call()
        out.append(str(ei.value))
    return out


def test_value_errors_match_jax(params):
    jeng, teng = _engines(params, **PAGED)
    want = _value_errors(jeng, JaxSP)
    assert _value_errors(teng, SamplingParams) == want
    assert "decode tail needs 6 KV pages" in want[5]
    assert jeng._next_id == teng._next_id == 0     # nothing was queued


def test_cancel_paged_request_mid_decode_frees_pages_and_window(params):
    """A paged request cancelled after two decode steps: its pages and its
    window keys go at once, a second request then runs, and tick events,
    accounting and stats equal JAX's."""
    prompt = _prompt(70, seed=13)
    runs = []
    for jax_side in (True, False):
        kw = {} if jax_side else dict(params=params, device="cpu")
        cls, cfg = (JaxEngine, JCFG) if jax_side else (LLMEngine, CFG)
        pre = cls(cfg, **PAGED, **kw)
        handoff = pre.prefill_paged(prompt, _sp(pre, max_tokens=8), span=32)
        dec = cls(cfg, max_batch=1, max_len=64, page_size=16, kv_pages=4,
                  seed=0, kv_gather_window=4, **kw)
        rid = dec.add_paged_request(handoff["parts"], handoff["len"],
                                    handoff["first"], _sp(dec, max_tokens=8))
        events = []
        for _ in range(3):
            dec.step()
            events += dec.take_tick_events()
        mid = (dec.kv_pages_free(), _gather_stats(dec)["resident"])
        assert dec.cancel_request(rid) and not dec.cancel_request(rid)
        after = (dec.kv_pages_free(), _gather_stats(dec), dec.has_unfinished())
        out = dec.decode_paged(handoff, _sp(dec, max_tokens=3))
        runs.append((events, mid, after, out, dec.kv_pages_free(),
                     _gather_stats(dec)))
    assert runs[1] == runs[0]
    events, mid, after, out, free, st = runs[1]
    # Admission's token and a decode token in the first step, then one per
    # step; one tail page of 4 held, the 3 parts resident.
    assert len(events) == 4 and mid == (3, 3)
    assert after[0] == 4 and after[1]["resident"] == 0 and not after[2]
    assert len(out) == 3 and free == 4 and st["resident"] == 0


# ---------------------------------------------- host-staged parts, audit ---

def _audits():
    """(the port's, JAX's) copy-audit counters."""
    return tdp.device_copy_stats(), jdp.device_copy_stats()


def _reset_audits():
    tdp._reset_copy_stats()
    jdp._reset_copy_stats()


def test_host_staged_prefill_matches_device_and_jax(params):
    """prefill_paged(host_staged=True): every part goes to host numpy
    (record_d2h) and the next chunk uploads it again (record_h2d); the
    first token and the parts bit for bit equal the device-resident
    prefill's, the first token equals JAX's host-staged one (parts within
    1e-5), and both audits move by the same bytes."""
    prompt = _prompt(90, seed=13)
    sp = dict(max_tokens=4)
    jeng = JaxEngine(JCFG, **PAGED)
    teng = LLMEngine(CFG, params, device="cpu", **PAGED)
    dev = teng.prefill_paged(prompt, SamplingParams(**sp), span=32)
    _reset_audits()
    staged = teng.prefill_paged(prompt, SamplingParams(**sp), span=32,
                                host_staged=True)
    want = jeng.prefill_paged(prompt, JaxSP(**sp), span=32,
                              host_staged=True)
    mine, theirs = _audits()
    assert staged["first"] == dev["first"] == want["first"]
    part_bytes = 0
    for s_, d, w in zip(staged["parts"], dev["parts"], want["parts"]):
        assert s_["span"] == d["span"] == w["span"]
        for name in ("k", "v"):
            host = s_["handle"][name]
            assert isinstance(host, np.ndarray) and host.dtype == np.float32
            assert torch.equal(torch.from_numpy(host), d["handle"][name])
            np.testing.assert_allclose(host, np.asarray(w["handle"][name]),
                                       rtol=1e-5, atol=1e-5)
            part_bytes += host.nbytes
    assert mine == theirs
    assert mine["device_to_host_bytes"] == part_bytes == 3 * 2 * (
        CFG.num_layers * 32 * CFG.num_kv_heads * CFG.head_dim_ * 4)
    # Chunk 1 uploads part 0 and chunk 2 part 1 as they first read them
    # (the window keeps each upload while it holds the part).
    assert mine["host_to_device_bytes"] == part_bytes // 3 * 2
    assert mine["device_fallback_bytes"] == 0


def test_paged_part_upload_counts_h2d_as_jax_does(params):
    """decode_paged over host-resident (numpy) parts counts each upload
    (window 2 under 4 parts: refetches upload again) exactly as JAX's does,
    and decodes JAX's tokens; device-resident parts count nothing. The
    parts are published to a store and fetched by key, each fetch a fresh
    dict, as from an arena (a by-value handle would keep JAX's upload in
    the handle itself across refetches, where the port's window drops it
    with the entry)."""
    prompt = _prompt(100, seed=14)
    counted = []
    for cls in (JaxEngine, LLMEngine):
        kw = {} if cls is JaxEngine else dict(params=params, device="cpu")
        cfg = JCFG if cls is JaxEngine else CFG
        store = {}

        def publish(part):
            store[len(store)] = part
            return len(store) - 1
        pre = cls(cfg, **PAGED, **kw)
        sp = _sp(pre, max_tokens=5)
        handoffs = [pre.prefill_paged(prompt, sp, span=32, host_staged=h,
                                      publish=publish, pipeline=False)
                    for h in (True, False)]
        outs = []
        for handoff in handoffs:
            dec = cls(cfg, kv_gather_window=2,
                      kv_fetch=lambda h: dict(store[h]), **PAGED, **kw)
            _reset_audits()
            outs.append(dec.decode_paged(handoff, sp))
            counted.append(_audits()[0 if cls is LLMEngine else 1][
                "host_to_device_bytes"])
        assert outs[0] == outs[1]
        counted.append(outs[0])
    jax_h2d, jax_dev_h2d, jax_out, h2d, dev_h2d, out = counted
    assert out == jax_out
    assert h2d == jax_h2d > 0 and dev_h2d == jax_dev_h2d == 0


def test_bf16_host_staged_parts_carry_their_dtype(params):
    """A bf16 engine's host-staged parts are the int16 bits of its parts,
    tagged "dtype": "bfloat16" (numpy has no bf16 of its own), and they
    decode to the device-resident handoff's tokens."""
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    bf16 = jax.tree.map(lambda t: t.to(torch.bfloat16), params)
    pre = LLMEngine(cfg, bf16, device="cpu", **PAGED)
    prompt = _prompt(70, seed=15)
    sp = SamplingParams(max_tokens=4)
    dev = pre.prefill_paged(prompt, sp, span=32)
    staged = pre.prefill_paged(prompt, sp, span=32, host_staged=True)
    assert staged["first"] == dev["first"]
    for s_, d in zip(staged["parts"], dev["parts"]):
        h = s_["handle"]
        assert h["dtype"] == "bfloat16" and h["k"].dtype == np.int16
        assert torch.equal(torch.from_numpy(h["k"]),
                           d["handle"]["k"].view(torch.int16))
    outs = [LLMEngine(cfg, bf16, device="cpu", **PAGED).decode_paged(h, sp)
            for h in (staged, dev)]
    assert outs[0] == outs[1]
