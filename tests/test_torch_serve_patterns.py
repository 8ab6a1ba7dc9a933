"""Parity of ray_tpu_torch's serving patterns with the JAX package's on the
CPU.

The reference deploys its apps on Serve and actors (tests/test_llm.py:111-127,
tests/test_pd_compiled.py, tests/test_long_context.py:305-420); the port
hosts each replica in process on a loop of its own thread. Both are held
to the JAX package: the ``build_*`` functions' ``Application`` fields equal
the reference's, and the apps' greedy tokens equal the JAX closed-loop
``LLMEngine``'s on the same ``tiny`` params (seed 0, converted with
``from_jax_params``, f32). The long-context cases are the reference's own:
part counts, gather counters, free pools and a typed lost shard.
"""

import copy
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.llm import build_dp_deployment as jax_build_dp_deployment
from ray_tpu.llm import build_llm_app as jax_build_llm_app
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu_torch import serve
from ray_tpu_torch._private import device_plane
from ray_tpu_torch.exceptions import StreamBrokenError
from ray_tpu_torch.llm import (CompiledPDApp, EngineReplica, LongContextApp,
                               build_dp_deployment, build_llm_app,
                               run_long_context_app, run_open_loop,
                               run_pd_app, run_pd_compiled)
from ray_tpu_torch.llm.serve_patterns import HostRef, Hosted
from ray_tpu_torch.models import PRESETS, from_jax_params

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
CPU = torch.device("cpu")
TIMEOUT_S = 120.0


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


def _want(prompt, n, max_len=96):
    """The JAX closed-loop engine's greedy tokens."""
    eng = JaxEngine(JCFG, max_batch=1, max_len=max_len, seed=0)
    return eng.generate([list(prompt)], JaxSP(max_tokens=n))[0]


def _blob_bytes(prompt, n) -> int:
    """Bytes of k and v of the JAX engine's P/D blob of ``prompt``."""
    eng = JaxEngine(JCFG, max_batch=1, max_len=96, seed=0)
    blob, _ = eng.prefill_only(list(prompt), JaxSP(max_tokens=n))
    return np.asarray(blob["k"]).nbytes + np.asarray(blob["v"]).nbytes


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size,
                                                n).tolist()


def _audit():
    return dict(device_plane.device_copy_stats())


def _moved(before) -> tuple:
    """(device-to-host, host-to-device) bytes since ``before``."""
    now = device_plane.device_copy_stats()
    return (now["device_to_host_bytes"] - before["device_to_host_bytes"],
            now["host_to_device_bytes"] - before["host_to_device_bytes"])


# ----------------------------------------------------------- build_* ---

@pytest.mark.parametrize("which,kw", [
    ("llm", {}),
    ("llm", dict(name="chat", min_replicas=1, max_replicas=3,
                 target_load=2.0, downscale_delay_s=5.0, kv_pages=12,
                 max_tokens=8, eos_id=2, num_tpus=1.0)),
    ("dp", {}),
    ("dp", dict(num_replicas=3, max_batch=2, max_tokens=4,
                temperature=0.5, num_cpus=2.0, num_tpus=4.0,
                prefix_cache=False, page_size=8)),
], ids=["llm-defaults", "llm-set", "dp-defaults", "dp-set"])
def test_build_functions_match_jax(params, which, kw):
    jax_fn, fn = {"llm": (jax_build_llm_app, build_llm_app),
                  "dp": (jax_build_dp_deployment, build_dp_deployment)}[which]
    want = jax_fn("tiny", **kw)
    got = fn("tiny", params=params, device="cpu", **kw)
    assert isinstance(got, serve.Application)
    for attr in ("name", "num_replicas", "ray_actor_options",
                 "route_prefix", "autoscaling_config"):
        assert getattr(got.deployment, attr) \
            == getattr(want.deployment, attr), attr
    assert got.deployment._target.__name__ \
        == want.deployment._target.__name__ == "EngineReplica"
    assert got.deployment._target is EngineReplica
    assert got.init_args == want.init_args == ("tiny",)
    assert got.init_kwargs == dict(want.init_kwargs, params=params,
                                   device="cpu")


def test_dp_app_replicas_match_jax(params):
    """tests/test_llm.py:111-118: every replica of the DP app gives the
    closed-loop engine's tokens."""
    app = build_dp_deployment("tiny", params=params, num_replicas=2,
                              max_tokens=4, max_len=64, seed=0,
                              device="cpu")
    dep = app.deployment
    hosts = [Hosted(dep._target(*app.init_args, **app.init_kwargs))
             for _ in range(dep.num_replicas)]
    prompt = [11, 22, 33, 44]
    want = _want(prompt, 4, max_len=64)
    try:
        assert [h.replica.engine.params for h in hosts] == [params] * 2
        for h in hosts:
            assert h.call(h.replica(prompt), TIMEOUT_S) == want
            items = list(h.stream(h.replica.stream_generate(prompt)))
            assert items == want + [{"finish_reason": "length",
                                     "n_tokens": 4}]
    finally:
        for h in hosts:
            h.shutdown()


# --------------------------------------------------------------- P/D ---

@pytest.mark.parametrize("direct", [True, False], ids=["direct", "by-value"])
def test_pd_app_matches_jax(params, direct):
    """tests/test_llm.py:121-127 and tests/test_pd_compiled.py:45-84: the
    ingress's tokens equal the closed-loop engine's over two decode
    replicas; each blob crosses the host once each way; the direct
    handoff carries a handle, and its buffer goes with the decode's read."""
    app = run_pd_app(CFG, params, decode_replicas=2, max_len=96, seed=0,
                     direct=direct, device="cpu")
    ing = app.replica
    prompt = [(i * 7) % 50 + 1 for i in range(64)]
    want = _want(prompt, 5)
    blob = _blob_bytes(prompt, 5)
    try:
        assert len(ing.prefill) == 1 and len(ing.decode) == 2
        assert ing.prefill[0].replica.engine.max_batch == 1
        assert {d.replica.engine.max_batch for d in ing.decode} == {4}
        for _ in range(2):              # both decode replicas
            before = _audit()
            assert app.call(ing(prompt, 5), TIMEOUT_S) == want
            assert _moved(before) == (blob, blob)
        stats = [d.debug_stats() for d in ing.decode]
        assert [s["completed"] for s in stats] == [1, 1]
        pre = ing.prefill[0]
        assert len(pre.buffers) == 0
        handoff = pre.call(pre.replica.prefill_handoff(
            {"prompt": prompt, "opts": {"max_tokens": 5}}), TIMEOUT_S)
        assert isinstance(handoff["ref"], HostRef) and "blob" not in handoff
        assert len(pre.buffers) == 1
        dec = ing.decode[0]
        res = dec.call(dec.replica.decode_handoff(handoff), TIMEOUT_S)
        assert res["tokens"] == want and len(pre.buffers) == 0
    finally:
        app.shutdown()
    assert all(h.loop.is_closed() for h in ing.prefill + ing.decode)


def test_a_dropped_handoff_frees_its_buffer(params):
    """A direct handoff that never reaches a decode replica (the ingress
    gave up on it) frees its blob's buffer when its last reference goes,
    as the object store frees an object with its last ref; a copy of the
    handle is the handle."""
    app = run_pd_app(CFG, params, max_len=96, seed=0, device="cpu")
    pre = app.replica.prefill[0]
    try:
        handoff = pre.call(pre.replica.prefill_handoff(
            {"prompt": [3, 1, 4, 1, 5], "opts": {"max_tokens": 2}}),
            TIMEOUT_S)
        ref = handoff["ref"]
        assert copy.copy(ref) is ref and copy.deepcopy(handoff)["ref"] is ref
        assert len(pre.buffers) == 1
        del handoff
        assert len(pre.buffers) == 1        # ``ref`` still holds it
        del ref
        assert len(pre.buffers) == 0
    finally:
        app.shutdown()


def test_compiled_pd_lanes_match_jax(params):
    """tests/test_pd_compiled.py:109-171: two lanes (one prefill replica,
    two decode replicas) taken round-robin; generate and stream give the
    closed-loop engine's tokens; each blob crosses the lane's edge once
    each way."""
    app = CompiledPDApp(CFG, params, prefill_replicas=1, decode_replicas=2,
                        max_len=96, seed=0, device="cpu")
    prompt = [5, 4, 3, 2, 9, 11]
    want = _want(prompt, 6)
    blob = _blob_bytes(prompt, 6)
    try:
        assert len(app._lanes) == 2 and app.num_replicas == 2
        assert {lane.pre for lane in app._lanes} == {app.prefills[0]}
        for _ in range(2):
            before = _audit()
            res = app.generate(prompt, {"max_tokens": 6})
            assert res == {"tokens": want, "finish_reason": "length"}
            assert _moved(before) == (blob, blob)
        for _ in range(2):
            items = list(app.stream(prompt, {"max_tokens": 6}))
            assert items[:-1] == want
            assert items[-1] == {"finish_reason": "length", "n_tokens": 6}
        stats = [d.debug_stats() for d in app.decodes]
        assert [s["completed"] for s in stats] == [2, 2]
        assert all(s["kv_pages_free"] + s["prefix_cache"]["allocated_pages"]
                   == s["kv_pages_total"] for s in stats)
    finally:
        app.shutdown()
    assert all(h.loop.is_closed() for h in app.prefills + app.decodes)


def test_replica_options_name_a_device(params):
    """``{"device": ...}`` places a replica; other options are refused."""
    app = run_pd_compiled(CFG, params=params, max_len=64, device="cpu",
                          prefill_options={"device": "cpu"})
    assert isinstance(app, CompiledPDApp)
    try:
        assert app.prefills[0].replica.engine.params is params
        assert app.decodes[0].replica.engine.device == CPU
    finally:
        app.shutdown()
    with pytest.raises(TypeError, match="num_gpus"):
        CompiledPDApp(CFG, params, max_len=64, device="cpu",
                      decode_options={"num_gpus": 1})


def test_apps_default_to_cuda_and_raise_without_it(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: run_pd_app(CFG, params),
                 lambda: CompiledPDApp(CFG, params),
                 lambda: LongContextApp(CFG, params),
                 lambda: build_llm_app("tiny", params=params),
                 lambda: build_dp_deployment("tiny", params=params)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ------------------------------------------------------- long context ---

LC = dict(prefill_shards=2, decode_replicas=1, span=32, max_len=64,
          page_size=16, kv_pages=4, seed=0, device="cpu")


def _shard_buffers(app, wait_s=5.0):
    """Each shard's live buffer count, once it reaches 0 or ``wait_s``
    passes: a thread that carried the last step may still be returning."""
    end = time.monotonic() + wait_s
    while True:
        n = [len(s.buffers) for s in app.shards]
        if not any(n) or time.monotonic() > end:
            return n
        time.sleep(0.01)


def test_long_context_app_matches_the_reference_case(params):
    """tests/test_long_context.py:305-360: a 160-token context that no
    pool holds (4 pages of 16), prefilled by 2 shards in 5 stripes of 32
    and decoded through a window of 3."""
    prompt = _prompt(160, seed=11)
    opts = {"max_tokens": 6}
    want = _want(prompt, 6, max_len=256)
    app = LongContextApp(CFG, params, kv_gather_window=3, max_tokens=6, **LC)
    try:
        handoff = app.prefill(prompt, opts, timeout=TIMEOUT_S)
        parts = handoff["parts"]
        assert len(parts) == 5 and handoff["len"] == 160
        assert all(isinstance(p["handle"], HostRef) for p in parts)
        assert [p["handle"].store for p in parts] == [
            app.shards[c % 2].buffers for c in range(5)]
        assert [len(s.buffers) for s in app.shards] == [3, 2]
        dec = app.decodes[0]
        rid = dec.call(dec.replica.admit_paged(handoff), TIMEOUT_S)
        items = list(dec.stream(dec.replica.collect_stream(rid)))
        assert items[:-1] == want
        assert items[-1]["finish_reason"] == "length"
        # The stripes live as long as their handles: once the request is
        # done and the handoff dropped, every shard's buffers are free.
        assert [len(s.buffers) for s in app.shards] == [3, 2]
        del handoff, parts
        assert _shard_buffers(app) == [0, 0]
        st = app.debug_stats()
        d = st["decodes"][0]
        assert d["kv_gather"]["fetches"] >= 5
        assert d["kv_gather"]["refetches"] > 0
        assert d["kv_gather"]["bytes"] > 0
        assert d["kv_pages_free"] == d["kv_pages_total"]
        for s in st["shards"]:
            assert s["kv_pages_free"] == s["kv_pages_total"]
        assert app.generate(prompt, opts)["tokens"] == want
        rep = run_open_loop(
            lambda p: app.stream(p, opts, timeout=TIMEOUT_S),
            rate_hz=3.0, duration_s=1.0,
            prompt_fn=lambda i: _prompt(160, seed=20 + i),
            num_replicas=1, request_timeout_s=TIMEOUT_S)
        assert rep["completed"] == rep["offered"] >= 3, rep
        assert rep["broken"] == 0 and not rep["errors"], rep
        assert rep["tokens_total"] == 6 * rep["completed"]
        assert _shard_buffers(app) == [0, 0]
    finally:
        app.shutdown()
    assert all(len(s.buffers) == 0 for s in app.shards)


def test_a_lost_shard_breaks_the_stream_typed(params):
    """tests/test_long_context.py:362-420, in process: shard 0, which
    holds stripes 0 and 2, is shut down mid-decode. The stream fails
    typed with the tokens it delivered, the decode replica's pages and
    window come back, and it serves a fresh request. The decode's fetches
    wait, once it has emitted 3 tokens, until the shard is gone."""
    prompt = _prompt(128, seed=13)
    app = run_long_context_app(CFG, params=params, kv_gather_window=1,
                               max_tokens=40, **LC)
    reached, go = threading.Event(), threading.Event()
    try:
        handoff = app.prefill(prompt, {"max_tokens": 40}, timeout=TIMEOUT_S)
        dec = app.decodes[0]
        rid = dec.call(dec.replica.admit_paged(handoff), TIMEOUT_S)
        req = dec.replica.engine._requests[rid]
        fetch = dec.replica._fetch

        def gated(handle):
            if len(req.out) >= 3:
                reached.set()
                assert go.wait(TIMEOUT_S)
            return fetch(handle)
        dec.replica._fetch = gated
        it = dec.stream(dec.replica.collect_stream(rid))
        got = [next(it) for _ in range(3)]
        assert all(isinstance(t, int) for t in got)
        assert reached.wait(TIMEOUT_S)
        app.shards[0].shutdown()
        go.set()
        with pytest.raises(StreamBrokenError) as ei:
            for item in it:
                assert not isinstance(item, dict), \
                    "stream finished cleanly despite KV loss"
        assert ei.value.tokens_emitted >= 3
        assert "cannot be fetched" in str(ei.value.__cause__)
        dec.replica._fetch = fetch
        d = dec.debug_stats()
        assert d["kv_broken"] == 1 and d["active"] == 0
        assert d["kv_pages_free"] == d["kv_pages_total"]
        assert d["kv_gather"]["resident"] == 0
        out = dec.call(dec.replica.generate(_prompt(5, seed=14),
                                            {"max_tokens": 3}), TIMEOUT_S)
        assert out["tokens"] == _want(_prompt(5, seed=14), 3, max_len=64)
    finally:
        go.set()
        app.shutdown()
