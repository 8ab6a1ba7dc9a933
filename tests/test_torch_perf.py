"""Parity of ray_tpu_torch's engine and device-plane microbenchmarks
(``util/perf.py`` and the bench entry of ``llm/sequence_parallel.py``) with
the JAX package's on the CPU.

The port's rows run with ``device="cpu"`` on the JAX package's seed-0
``tiny`` params (``ray_tpu.models.init_params(cfg, jax.random.key(0))``,
carried across with ``from_jax_params``). What is held against the JAX
package is what a row computes apart from its times: the prefix-cache hit
rates (the reference's own script, run in process), the bench entry's keys,
the first token of the paged path, the SP prefill's logits, the P/D pair's
greedy streams, and the device channel's and KV handoff's payloads and
copy-audit deltas. A row whose engine raises must raise, never return 0.0.
"""

import contextlib
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jax_models
from ray_tpu._private import device_plane as jdp
from ray_tpu._private import serialization as jser
from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.llm import sequence_parallel as jsp
from ray_tpu.llm.engine import _prefill_fn as jax_prefill_fn
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu.util import perf as ref
from ray_tpu_torch._private import device_plane as tdp
from ray_tpu_torch._private import serialization as tser
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.llm import sequence_parallel as tsp
from ray_tpu_torch.models import PRESETS, from_jax_params
from ray_tpu_torch.util import perf

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)
MIN_TIME_S = 0.1
# The bench entry at a small size on both sides: 4 sp shards over 64
# tokens, a 96-token context in 32-token parts, one timed prefill.
BENCH_ARGS = ["--bench", "--degree", "4", "--tokens", "64", "--iters", "1",
              "--context", "96", "--span", "32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jax_models.init_params(JCFG, jax.random.key(0))


@pytest.fixture(scope="module")
def params(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams), CFG, "cpu")


@pytest.fixture(scope="module")
def run(params):
    """One run of every row on the CPU: (results, each report's whole
    result)."""
    details: dict = {}
    res = perf.run_microbenchmarks(MIN_TIME_S, cfg="tiny", params=params,
                                   device="cpu", details=details)
    return res, details


def _audit_delta(stats, before) -> dict:
    return {k: stats()[k] - before[k] for k in before}


# ------------------------------------------------------------- the runner --

def test_rows_are_the_references_rows_in_its_order(run):
    res, _ = run
    assert list(res) == [n for n in ref.BENCHES if n in perf.BENCHES]
    assert len(res) == 13
    for name, row in res.items():
        assert set(row) == {"value", "unit"}
        assert name in ref.UNITS and row["unit"] == perf.UNITS[name]
        assert math.isfinite(row["value"]) and row["value"] > 0, name
    rows = set(perf.BENCHES)
    assert perf.LOWER_IS_BETTER == ref.LOWER_IS_BETTER & rows
    for group in ("SERVING_METRICS", "LONG_CONTEXT_METRICS",
                  "DEVICE_PLANE_METRICS", "MEMORY_TIER_METRICS"):
        assert getattr(perf, group) == tuple(
            m for m in getattr(ref, group) if m in rows), group


def test_serving_rows_serve_every_request_in_full(run):
    _, details = run
    for name in ("serving", "pd_serving"):
        ol = details[name]["open_loop"]
        assert ol["offered"] == ol["completed"] == 16, name
        assert ol["tokens_total"] == 16 * 16, name
        assert not (ol["shed"] or ol["broken"] or ol["errors"]
                    or ol["unfinished"]), name
    assert details["long_context"]["sp_degree"] == 4


@pytest.mark.parametrize("only", [
    ["device_channel_steps_per_s"],
    ["device_channel_steps_per_s_host", "kv_handoff_gibs"],
])
def test_only_returns_the_named_rows(only):
    res = perf.run_microbenchmarks(0.02, only=only, device="cpu")
    assert list(res) == only


def test_main_prints_one_json_line(capsys):
    assert perf.main(["--min-time-s", "0.02", "--device", "cpu", "--only",
                      "device_channel_steps_per_s"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert list(json.loads(lines[0])) == ["device_channel_steps_per_s"]


# -------------------------------------------------- prefix cache rows ---

def test_prefix_cache_rows_equal_the_reference_script(run):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(compile(ref._KV_PRESSURE_SCRIPT, "<kv-pressure>", "exec"), {})
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    kv = run[1]["kv_pressure"]
    assert kv["prefix_cache_hit_rate_under_pressure"] \
        == want["with_demotion"] == 9 / 11
    assert kv["prefix_cache_hit_rate_nodemote"] \
        == want["without_demotion"] == 4 / 11
    assert (kv["with_demotion"]["hits"], kv["with_demotion"]["misses"]) \
        == (9, 2)
    assert (kv["without_demotion"]["hits"],
            kv["without_demotion"]["misses"]) == (4, 7)
    assert run[0]["prefix_cache_hit_rate_under_pressure"]["value"] == 0.82
    assert run[0]["prefix_cache_hit_rate_nodemote"]["value"] == 0.36


# ---------------------------------------------------- long-context rows ---

def test_bench_main_prints_the_references_keys(capsys):
    assert jsp._bench_main(BENCH_ARGS) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tsp._bench_main(BENCH_ARGS + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert got["sp_degree"] == want["sp_degree"] == 4
    assert all(v > 0 for v in got.values())


@pytest.mark.parametrize("degree", [1, 4])
def test_sp_prefill_logits_equal_jax(jparams, params, degree):
    tokens = 64
    logits, ks, _ = tsp._sp_prefill_call(degree, tokens, "ring", CFG, params,
                                         CPU)()
    toks = jnp.asarray(np.random.default_rng(0).integers(
        1, CFG.vocab_size, (1, tokens)), jnp.int32)
    if degree == 1:
        want = jax_prefill_fn(jparams, toks, tokens, JCFG)
    else:
        want = jsp.sp_prefill_fn(jparams, toks, tokens, JCFG,
                                 jsp.sp_mesh(degree, jax.devices()[:degree]),
                                 "ring")
    np.testing.assert_allclose(logits.numpy(), np.asarray(want[0]), **TOL)
    ks = ks[0] if isinstance(ks, list) else ks     # degree 1: per position
    np.testing.assert_allclose(ks.numpy(), np.asarray(want[1]), **TOL)


def _jax_first(pre, dec, prompt, sp, kw) -> int:
    """The reference's timed serve (``_bench_long_context_ttft``'s loop
    body), returning the first token."""
    handoff = pre.prefill_paged(prompt, sp, **kw)
    rid = dec.add_paged_request(handoff["parts"], handoff["len"],
                                handoff["first"], sp)
    first = None
    while dec.has_unfinished() and first is None:
        dec.step()
        for ev_rid, tok, _fin in dec.take_tick_events():
            if ev_rid == rid:
                first = int(tok)
                break
    dec.cancel_request(rid)
    return first


@pytest.mark.parametrize("host_staged", [False, True])
def test_long_context_first_token_equals_jax(params, host_staged):
    context, span = 96, 32
    prompt = [int(t) for t in np.random.default_rng(1).integers(
        1, CFG.vocab_size, context)]
    kw = dict(span=span, host_staged=host_staged, pipeline=not host_staged)
    pre, dec = tsp._long_context_engines(CFG, params, CPU)
    ms, got = tsp._long_context_first(pre, dec, prompt,
                                      SamplingParams(max_tokens=4), kw)
    jengines = [JaxEngine(JCFG, max_batch=1, max_len=64, page_size=16,
                          kv_pages=4, seed=0) for _ in range(2)]
    want = _jax_first(*jengines, prompt, JaxSP(max_tokens=4), kw)
    assert got == want and ms > 0
    assert not dec.has_unfinished() and dec.kv_pages_free() == 4


# ------------------------------------------------------------ P/D pair ---

def test_pd_streams_equal_jax_prefill_only_then_decode_from(params):
    pre, dec = perf._pd_pair(CFG, params, CPU)
    jpre = JaxEngine(JCFG, max_batch=1, max_len=64, page_size=8, seed=0,
                     prefix_cache=True)
    jdec = JaxEngine(JCFG, max_batch=4, max_len=64, page_size=8, seed=0,
                     prefix_cache=True)
    before = tdp.device_copy_stats()
    blob_bytes = 0
    try:
        for i in range(3):
            prompt = perf._prompt(i)
            items = list(perf._pd_stream(pre, dec, prompt))
            got = [t for t in items if not isinstance(t, dict)]
            assert items[-1] == {"finish_reason": "length", "n_tokens": 16}
            blob, first = jpre.prefill_only(prompt, JaxSP(max_tokens=16))
            want = jdec.decode_from(blob, first, JaxSP(max_tokens=16))
            assert got == list(want) and len(got) == 16, i
            blob_bytes += np.asarray(blob["k"]).nbytes \
                + np.asarray(blob["v"]).nbytes
    finally:
        pre.close()
        dec.close()
    delta = _audit_delta(tdp.device_copy_stats, before)
    # Rung 1: each blob staged once to the host buffer and uploaded once.
    assert delta["device_to_host_bytes"] == blob_bytes
    assert delta["host_to_device_bytes"] == blob_bytes
    assert delta["device_arrays_staged"] == 6


# --------------------------------------------------------- device plane ---

@pytest.mark.parametrize("kind", ["dev", "host"])
def test_device_channel_payload_and_audit_equal_the_references(kind):
    n = perf._DEV_PAYLOAD_ELEMS
    buf = perf._host_buffer(n * 4 + (1 << 16), CPU)
    payload = (torch.arange(n, dtype=torch.float32) if kind == "dev"
               else np.arange(n, dtype=np.float32))
    held = tdp.local_registry_size()
    before = tdp.device_copy_stats()
    out = perf._channel_step(tser.get_context(), payload, buf)
    got = _audit_delta(tdp.device_copy_stats, before)
    if kind == "dev":
        assert out.data_ptr() == payload.data_ptr()     # the same tensor
    assert np.array_equal(np.asarray(out), np.asarray(payload))
    assert tdp.local_registry_size() == held

    jpayload = (jnp.arange(n, dtype=jnp.float32) if kind == "dev"
                else np.arange(n, dtype=np.float32))
    jbuf = memoryview(bytearray(n * 4 + (1 << 16)))
    jheld = jdp.local_registry_size()
    jbefore = jdp.device_copy_stats()
    jctx = jser.get_context()
    parts, _ = jdp.dag_encode_body(jctx, b"\x00", jpayload, True, 1)
    jout = jdp.dag_decode_body(jctx, jbuf[:jser.write_parts_into(parts,
                                                                  jbuf)])
    want = _audit_delta(jdp.device_copy_stats, jbefore)
    assert np.array_equal(np.asarray(jout), np.asarray(jpayload))
    assert jdp.local_registry_size() == jheld
    assert got == want
    assert got["device_arrays_local"] == (1 if kind == "dev" else 0)


def test_kv_handoff_payload_and_audit_equal_the_references():
    chunk_mb = 1
    blob = perf._kv_blob(chunk_mb, CPU)
    buf = perf._host_buffer((chunk_mb << 20) + (1 << 16), CPU)
    before = tdp.device_copy_stats()
    out = perf._kv_handoff_round(tser.get_context(), blob, buf, CPU)
    got = _audit_delta(tdp.device_copy_stats, before)
    for k in ("k", "v"):
        assert out[k].device == CPU
        assert out[k].data_ptr() != blob[k].data_ptr()
        assert torch.equal(out[k], blob[k])
    assert out["len"] == blob["len"]

    half = (chunk_mb << 20) // 8
    jblob = {"k": jnp.arange(half, dtype=jnp.float32),
             "v": jnp.arange(half, dtype=jnp.float32), "len": half}
    jctx = jser.get_context()
    jbuf = memoryview(bytearray((chunk_mb << 20) + (1 << 16)))
    jbefore = jdp.device_copy_stats()
    n = jser.write_parts_into(jctx.serialize(jblob), jbuf)
    jout = jctx.deserialize(jbuf[:n])
    want = _audit_delta(jdp.device_copy_stats, jbefore)
    assert np.array_equal(np.asarray(jout["k"]), out["k"].numpy())
    assert got == want
    assert got["device_to_host_bytes"] == got["host_to_device_bytes"] \
        == chunk_mb << 20


# ------------------------------------------------------------- failures ---

def _boom(*_a, **_k):
    raise RuntimeError("boom")


@pytest.mark.parametrize("row, owner, attr", [
    ("serving_ttft_p50_ms", LLMEngine, "step"),
    ("serving_pd_ttft_p50_ms", LLMEngine, "prefill_only"),
    ("sp_prefill_tokens_per_s", tsp, "sp_prefill_fn"),
    ("long_context_ttft_ms", LLMEngine, "prefill_paged"),
    ("prefix_cache_hit_rate_under_pressure", LLMEngine, "generate"),
    ("device_channel_steps_per_s", tdp, "dag_decode_body"),
    ("kv_handoff_gibs", tser.SerializationContext, "deserialize"),
])
def test_a_failing_row_raises(monkeypatch, params, row, owner, attr):
    monkeypatch.setattr(owner, attr, _boom)
    with pytest.raises(RuntimeError, match="boom"):
        perf.run_microbenchmarks(0.02, only=[row], params=params,
                                 device="cpu")


def _full_report(**kw) -> dict:
    rep = {"offered": 4, "completed": 4, "shed": 0, "broken": 0,
           "errors": [], "unfinished": 0, "tokens_total": 64}
    rep.update(kw)
    return rep


def test_a_full_open_loop_passes():
    perf._check_open_loop(_full_report(), "serving")


@pytest.mark.parametrize("fault", [
    dict(shed=1, completed=3, tokens_total=48),
    dict(broken=1, completed=3, tokens_total=48),
    dict(errors=["RayError('failed')"], completed=3, tokens_total=48),
    dict(unfinished=1, completed=3, tokens_total=48),
    dict(tokens_total=63),
])
def test_a_lost_or_short_request_fails_the_row(fault):
    with pytest.raises(RuntimeError, match="did not serve every request"):
        perf._check_open_loop(_full_report(**fault), "serving")
