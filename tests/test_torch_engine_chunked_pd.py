"""Parity of ray_tpu_torch's chunked prefill, cancellation and
prefill/decode disaggregation with the JAX engine on the CPU.

The JAX engine's ``tiny`` params (f32) are carried across; inputs come from
a numpy seed. Greedy tokens, tick events and page accounting must be
identical to the JAX engine's after the same calls (the port of
tests/test_long_context.py:148-196 among them). A P/D blob shipped through
each package's serializer must give the same tokens, with copy-audit
counters equal to each other and to the blob's bytes.
"""

import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private import device_plane as jdp
from ray_tpu._private import serialization as jser
from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu_torch._private import device_plane as tdp
from ray_tpu_torch._private import serialization as tser
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.llm import engine as torch_engine
from ray_tpu_torch.models import PRESETS, from_jax_params
from ray_tpu_torch.parallel import MeshSpec, build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    """A JAX engine and a port engine over the same params."""
    jeng = JaxEngine(JCFG, **kw)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG,
                             "cpu")
    return jeng, LLMEngine(CFG, params, device="cpu", **kw)


def _sp(eng, **kw):
    return (JaxSP if isinstance(eng, JaxEngine) else SamplingParams)(**kw)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size,
                                                n).tolist()


def _drain(eng):
    """Step until idle; {req_id: (tokens, finish_reason)} of what finished."""
    out = {}
    while eng.has_unfinished():
        for req in eng.step():
            out[req.req_id] = (req.out, req.finish_reason)
    return out


def _accounting(eng):
    return dict(free=eng.kv_pages_free(), queue=eng.queue_depth,
                active=eng.active_requests, busy=eng.has_unfinished(),
                occupancy=eng.kv_page_occupancy(),
                stats=eng.prefix_cache_stats())


# ------------------------------------------------------- chunked prefill ---

def test_chunked_prefill_parity_and_tick_bound(monkeypatch):
    """A 120-token prompt advances one 32-token chunk per tick: an already
    decoding request emits a token every tick, the tick events equal the
    JAX engine's, the tokens equal the unchunked engine's, and prefill
    only ever runs at the chunk's bucket."""
    long_p, short_p = _prompt(120, seed=3), _prompt(6, seed=4)
    jbase, tbase = _pair(max_batch=2, max_len=256, seed=0)
    expect = [jbase.generate([p], JaxSP(max_tokens=24))[0]
              for p in (long_p, short_p)]
    assert [tbase.generate([p], SamplingParams(max_tokens=24))[0]
            for p in (long_p, short_p)] == expect

    buckets = []
    for name in ("_prefill_fn", "_suffix_prefill_fn"):
        real = getattr(torch_engine, name)

        def spy(*args, _real=real, _name=name):
            tokens = args[1] if _name == "_prefill_fn" else args[4]
            buckets.append((_name, tokens.shape[1]))
            return _real(*args)
        monkeypatch.setattr(torch_engine, name, spy)

    runs = []
    for eng in _pair(max_batch=2, max_len=256, seed=0, page_size=16,
                     prefill_chunk=32):
        ticks = []
        rid_s = eng.add_request(short_p, _sp(eng, max_tokens=24))
        eng.step()                                   # short admitted
        ticks.append(eng.take_tick_events())
        rid_l = eng.add_request(long_p, _sp(eng, max_tokens=24))
        during = 0
        while eng.has_unfinished():
            eng.step()
            ticks.append(eng.take_tick_events())
            if eng._prefilling:
                during += sum(r == rid_s for r, _, _ in ticks[-1])
        out = {}
        for rid, tok, _ in (e for tick in ticks for e in tick):
            out.setdefault(rid, []).append(tok)
        runs.append((ticks, [out[rid_l], out[rid_s]], during))
    assert runs[1] == runs[0]
    ticks, outs, during = runs[1]
    assert outs == expect
    assert during >= 3                      # the decode never starved
    # Full prefills for the short prompt (bucket 8) and the first chunk,
    # then three suffix chunks: the 128-token bucket never runs.
    assert buckets == [("_prefill_fn", 8), ("_prefill_fn", 32)] \
        + [("_suffix_prefill_fn", 32)] * 3


@pytest.mark.parametrize("chunk,want", [(20, 16), (5, 8), (64, 64)])
def test_prefill_chunk_rounds_to_a_page_multiple(chunk, want):
    jeng, teng = _pair(max_batch=1, max_len=128, page_size=8,
                       prefill_chunk=chunk)
    assert teng.prefill_chunk == jeng.prefill_chunk == want


def test_chunked_prefill_from_a_prefix_hit_matches_jax():
    """The slice together: a prefix-cache hit whose suffix is longer than a
    chunk advances by suffix chunks only, beside a shipped (P/D) request;
    tick events, tokens and cache stats equal the JAX engine's."""
    base = _prompt(40, seed=7)
    first, second = base + _prompt(5, seed=8), base + _prompt(30, seed=9)
    kw = dict(max_batch=3, max_len=128, seed=0, page_size=8,
              prefill_chunk=16, prefix_cache=True)
    jpre = JaxEngine(JCFG, max_batch=1, max_len=128, seed=0, page_size=8)
    blob, tok = jpre.prefill_only(_prompt(12, seed=10), JaxSP(max_tokens=6))
    np_blob = {"k": np.asarray(blob["k"]), "v": np.asarray(blob["v"]),
               "len": blob["len"]}
    runs = []
    for eng, b in zip(_pair(**kw), (blob, np_blob)):
        ticks = [eng.generate([first], _sp(eng, max_tokens=4))]
        eng.add_request(second, _sp(eng, max_tokens=6))
        eng.add_external_request(b, tok, _sp(eng, max_tokens=6))
        while eng.has_unfinished():
            eng.step()
            ticks.append((eng.take_tick_events(), sorted(eng._prefilling)))
        runs.append((ticks, eng.prefix_cache_stats()))
    assert runs[1] == runs[0]
    assert runs[1][1]["hits"] == 1 and runs[1][1]["hit_pages"] == 5


# ---------------------------------------------------------- cancellation ---

@pytest.mark.parametrize("state", ["waiting", "prefilling", "active"])
def test_cancel_request_matches_jax(state):
    """Cancel a request while it waits, while it is mid-chunked-prefill and
    mid-decode: its pages return at once, and every count equals the JAX
    engine's after the same calls, through to a drained cache."""
    kw = dict(max_batch=1, max_len=128, seed=0, page_size=8,
              prefill_chunk=16, prefix_cache=True)
    runs = []
    for eng in _pair(**kw):
        a = eng.add_request(_prompt(40, seed=1), _sp(eng, max_tokens=8))
        b = eng.add_request(_prompt(10, seed=2), _sp(eng, max_tokens=8))
        eng.step()                  # a reserved, its first 16-token chunk
        if state == "active":
            while a not in {r.req_id for r in eng._slots.values()}:
                eng.step()
            eng.step()
        target = {"waiting": b, "prefilling": a, "active": a}[state]
        before = _accounting(eng)
        cancelled = eng.cancel_request(target)
        after = _accounting(eng)
        again = eng.cancel_request(target)
        finished = _drain(eng)
        while eng._cache._entries:
            eng._cache.evict_lru(eng._decref)
        runs.append((before, cancelled, after, again, finished,
                     _accounting(eng)))
    assert runs[1] == runs[0]
    before, cancelled, after, again, finished, end = runs[1]
    assert cancelled and not again
    assert target not in finished
    if state != "waiting":
        assert after["free"] > before["free"]
    assert end["occupancy"] == 0.0 and not end["busy"]
    assert end["stats"]["allocated_pages"] == 0


def test_cancelled_request_reads_cancelled():
    _, teng = _pair(max_batch=1, max_len=64, page_size=8)
    rid = teng.add_request([1, 2, 3], SamplingParams(max_tokens=8))
    teng.step()
    req = teng._requests[rid]
    assert teng.cancel_request(rid) and req.finished
    assert req.finish_reason == "cancelled" and req.pages == []
    assert teng.kv_pages_free() == teng.kv_pages_total
    assert teng.cancel_request(12345) is False


# ------------------------------------------------------------------- P/D ---

def test_prefill_only_and_decode_from_match_jax():
    prompt = _prompt(21, seed=5)
    jref, _ = _pair(max_batch=1, max_len=64, seed=0, page_size=8)
    jpre, tpre = _pair(max_batch=1, max_len=64, seed=0, page_size=8)
    jdec, tdec = _pair(max_batch=2, max_len=64, seed=0, page_size=8)
    jblob, jfirst = jpre.prefill_only(prompt, JaxSP(max_tokens=6))
    tblob, tfirst = tpre.prefill_only(prompt, SamplingParams(max_tokens=6))
    assert tfirst == jfirst and tblob["len"] == jblob["len"] == 21
    for name in ("k", "v"):
        assert isinstance(tblob[name], torch.Tensor)
        assert tuple(tblob[name].shape) == jblob[name].shape == (
            CFG.num_layers, 21, CFG.num_kv_heads, CFG.head_dim_)
        np.testing.assert_allclose(tblob[name].numpy(),
                                   np.asarray(jblob[name]), rtol=1e-4,
                                   atol=1e-4)
    want = jdec.decode_from(jblob, jfirst, JaxSP(max_tokens=6))
    got = tdec.decode_from(tblob, tfirst, SamplingParams(max_tokens=6))
    assert got == want == jref.generate([prompt], JaxSP(max_tokens=6))[0]
    assert got[0] == tfirst
    assert tdec.kv_pages_free() == tdec.kv_pages_total


def test_pd_prefix_hits_on_both_sides():
    """The port of test_llm_serving.py:124-140: the prefill side learns the
    prefix from prefill_only, the decode side from decode_from's
    prompt_tokens, so the second prompt hits on both."""
    prefix = list(range(5, 25))
    pA, pB = prefix + [30, 31], prefix + [40, 41, 42]
    jref, _ = _pair(max_batch=1, max_len=64, seed=0, page_size=8)
    jpre, tpre = _pair(max_batch=1, max_len=64, seed=0, page_size=8,
                       prefix_cache=True)
    jdec, tdec = _pair(max_batch=2, max_len=64, seed=0, page_size=8,
                       prefix_cache=True)
    for prompt in (pA, pB):
        jblob, jfirst = jpre.prefill_only(prompt, JaxSP(max_tokens=5))
        tblob, tfirst = tpre.prefill_only(prompt,
                                          SamplingParams(max_tokens=5))
        assert tfirst == jfirst
        want = jdec.decode_from(jblob, jfirst, JaxSP(max_tokens=5),
                                prompt_tokens=prompt)
        got = tdec.decode_from(tblob, tfirst, SamplingParams(max_tokens=5),
                               prompt_tokens=prompt)
        assert got == want == jref.generate([prompt],
                                            JaxSP(max_tokens=5))[0]
    for t, j in ((tpre, jpre), (tdec, jdec)):
        assert t.prefix_cache_stats() == j.prefix_cache_stats()
        assert t.prefix_cache_stats()["hits"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_tokens", [False, True])
def test_jax_blob_decodes_in_the_port(dtype, with_tokens):
    """A blob from the JAX engine's prefill_only, carried as numpy (bf16 as
    ml_dtypes' bfloat16), decodes in the port to the JAX decode's tokens."""
    prompt = _prompt(30, seed=6)
    tokens = prompt if with_tokens else None
    jpre = JaxEngine(JCFG, max_batch=1, max_len=64, seed=0, page_size=8)
    blob, first = jpre.prefill_only(prompt, JaxSP(max_tokens=6))
    blob = {"k": jnp.asarray(blob["k"], dtype),
            "v": jnp.asarray(blob["v"], dtype), "len": blob["len"]}
    np_blob = {"k": np.asarray(blob["k"]), "v": np.asarray(blob["v"]),
               "len": blob["len"]}
    assert np_blob["k"].dtype.name == dtype
    jdec, tdec = _pair(max_batch=2, max_len=64, seed=0, page_size=8,
                       prefix_cache=True)
    want = jdec.decode_from(blob, first, JaxSP(max_tokens=6),
                            prompt_tokens=tokens)
    got = tdec.decode_from(np_blob, first, SamplingParams(max_tokens=6),
                           prompt_tokens=tokens)
    assert got == want
    assert tdec.prefix_cache_stats() == jdec.prefix_cache_stats()


def test_sample_first_matches_jax():
    jeng, teng = _pair(max_batch=1, max_len=64, page_size=8)
    logits = np.random.default_rng(0).standard_normal(
        CFG.vocab_size).astype(np.float32)
    got = teng.sample_first(torch.from_numpy(logits))
    assert got == jeng.sample_first(jnp.asarray(logits)) \
        == int(logits.argmax())


# -------------------------------------------- P/D through the serializer ---

def _ship(ctx, blob) -> bytearray:
    """The blob as the arena would hold it: serialized, then written into
    one destination buffer with no part copied on the way."""
    parts = ctx.serialize(blob)
    assert tser.copied_part_bytes(parts) == 0
    arena = bytearray(ctx.total_size(parts))
    tser.write_parts_into(parts, memoryview(arena))
    return arena


def _blob_bytes(blob) -> int:
    return sum(np.asarray(blob[n]).nbytes for n in ("k", "v"))


def test_pd_blob_through_the_serializer_matches_jax():
    """prefill_only's blob shipped as bytes and decoded: the tokens equal
    the in-process handoff's and the JAX engine's (exact, greedy); each
    side stages the blob exactly once each way (d2h == h2d == the blob's
    bytes, no fallback), the two audits equal."""
    prompt = _prompt(40, seed=7)
    sp = dict(max_tokens=6)
    jpre, tpre = _pair(max_batch=1, max_len=64, seed=0, page_size=8)
    jdec, tdec = _pair(max_batch=2, max_len=64, seed=0, page_size=8)
    jblob, jfirst = jpre.prefill_only(prompt, JaxSP(**sp))
    tblob, tfirst = tpre.prefill_only(prompt, SamplingParams(**sp))
    in_process = tdec.decode_from(tblob, tfirst, SamplingParams(**sp))
    want = jdec.decode_from(jblob, jfirst, JaxSP(**sp))
    nbytes = _blob_bytes(tblob)
    assert nbytes == _blob_bytes(jblob) == 2 * 2 * 40 * 4 * 16 * 4
    assert all(tblob[n].is_contiguous() for n in ("k", "v"))

    jdp._reset_copy_stats()
    tdp._reset_copy_stats()
    tdp.set_landing_device("cpu")
    try:
        t_arena = _ship(tser.get_context(), tblob)
        j_arena = _ship(jser.get_context(), jblob)
        tgot = tser.get_context().deserialize(memoryview(t_arena))
        jgot = jser.get_context().deserialize(memoryview(j_arena))
    finally:
        tdp._tls.__dict__.pop("landing", None)
    t_arena[:] = bytes(len(t_arena))        # nothing may alias the arena
    assert tgot["len"] == 40 and isinstance(tgot["k"], torch.Tensor)
    for n in ("k", "v"):
        assert torch.equal(tgot[n], tblob[n])
    assert tdp.device_copy_stats() == jdp.device_copy_stats() == dict(
        device_to_host_bytes=nbytes, host_to_device_bytes=nbytes,
        device_fallback_bytes=0, device_arrays_staged=2,
        device_arrays_local=0)
    got = tdec.decode_from(tgot, tfirst, SamplingParams(**sp))
    assert got == in_process == want == jdec.decode_from(jgot, jfirst,
                                                         JaxSP(**sp))
    assert tdec.kv_pages_free() == tdec.kv_pages_total


def test_tp_blob_joined_at_export_stages_once():
    """A tp=2 engine's blob is joined onto its device at export: it ships
    like an unsharded engine's, each of k and v staged once and no byte of
    fallback, and an unsharded engine decodes it to the tokens of its own
    generation."""
    prompt = _prompt(30, seed=8)
    sp = SamplingParams(max_tokens=5)
    jref, flat = _pair(max_batch=2, max_len=64, seed=0, page_size=8)
    tp = LLMEngine(CFG, flat.params, device="cpu", max_batch=1,
                   max_len=64, page_size=8,
                   mesh=build_mesh(MeshSpec(tp=2), devices=["cpu"] * 2))
    blob, first = tp.prefill_only(prompt, sp)
    tdp._reset_copy_stats()
    tdp.set_landing_device("cpu")
    try:
        got = tser.get_context().deserialize(
            memoryview(_ship(tser.get_context(), blob)))
    finally:
        tdp._tls.__dict__.pop("landing", None)
    st = tdp.device_copy_stats()
    assert st["device_to_host_bytes"] == st["host_to_device_bytes"] \
        == _blob_bytes(blob) and st["device_fallback_bytes"] == 0
    assert st["device_arrays_staged"] == 2
    assert flat.decode_from(got, first, sp) == flat.generate([prompt], sp)[0] \
        == jref.generate([prompt], JaxSP(max_tokens=5))[0]


_CHILD = """
import hashlib, json, sys
from ray_tpu_torch._private import device_plane, serialization
device_plane.set_landing_device("cpu")
data = open(sys.argv[1], "rb").read()
blob = serialization.get_context().deserialize(memoryview(data))
print(json.dumps({
    "sha256": {n: hashlib.sha256(blob[n].numpy().tobytes()).hexdigest()
               for n in ("k", "v")},
    "len": blob["len"], "dtype": str(blob["k"].dtype),
    "h2d": device_plane.device_copy_stats()["host_to_device_bytes"]}))
"""


def test_pd_blob_rebuilds_in_another_process(tmp_path):
    """The serialized blob rebuilt by a second Python process (landing on
    the CPU, as it asks): the same bytes, and its own audit counts the
    upload of exactly the blob's bytes. The only subprocess of the file."""
    prompt = _prompt(33, seed=9)
    _, tpre = _pair(max_batch=1, max_len=64, seed=0, page_size=8)
    blob, _ = tpre.prefill_only(prompt, SamplingParams(max_tokens=2))
    path = tmp_path / "blob.bin"
    path.write_bytes(_ship(tser.get_context(), blob))
    res = subprocess.run([sys.executable, "-c", _CHILD, str(path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {
        "sha256": {n: hashlib.sha256(blob[n].numpy().tobytes()).hexdigest()
                   for n in ("k", "v")},
        "len": 33, "dtype": "torch.float32", "h2d": _blob_bytes(blob)}
