"""Parity of ray_tpu_torch's tensor-parallel serving with the JAX package's
on the CPU (the ports of tests/test_llm.py:196-214 and :235-257, and the
engine's features under a tp mesh).

JAX shards its engine over a tp mesh of the conftest's CPU devices (GSPMD);
the port runs on a mesh that names the CPU n times, each position holding
its heads, kv heads and MLP hidden units (``tp_shards``) and all-reducing
in f32. The JAX engine's ``tiny`` params (f32) are carried across. Greedy
tokens, tick events, cache and window counters and page accounting are
equal; logits, KV blobs and parts agree within 1e-4 (f32 sums in another
order).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.llm.serving import EngineReplica as JaxReplica
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu.models.transformer import forward as jax_forward
from ray_tpu.models.transformer import \
    param_logical_axes as jax_param_logical_axes
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu.parallel.sharding import tree_shardings as jax_tree_shardings
from ray_tpu_torch.llm import EngineReplica, LLMEngine, SamplingParams
from ray_tpu_torch.llm import engine as torch_engine
from ray_tpu_torch.models import PRESETS, forward, from_jax_params
from ray_tpu_torch.parallel import MeshSpec, build_mesh

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
# A replica's whole script: generous, so that a stuck wait fails with the
# test's name instead of eating the suite's time limit.
SCRIPT_TIMEOUT_S = 120.0


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
    """The JAX engine's seed-0 ``tiny`` params, and the port's copy."""
    jp = JaxEngine(JCFG, max_batch=1, max_len=64, seed=0).params
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), CFG, "cpu")


def _meshes(n):
    """A tp=n JAX mesh on the CPU devices and the port's on the CPU."""
    return (jax_build_mesh(JaxMeshSpec(tp=n), devices=jax.devices()[:n]),
            build_mesh(MeshSpec(tp=n), devices=[CPU] * n))


def _pair(params, n, **kw):
    """(JAX engine, port engine) on tp=n meshes over the same params."""
    jmesh, mesh = _meshes(n)
    return (JaxEngine(JCFG, params[0], mesh=jmesh, **kw),
            LLMEngine(CFG, params[1], device="cpu", mesh=mesh, **kw))


def _sp(eng, **kw):
    return (JaxSP if isinstance(eng, JaxEngine) else SamplingParams)(**kw)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size,
                                                n).tolist()


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _accounting(eng):
    return dict(free=eng.kv_pages_free(), queue=eng.queue_depth,
                active=eng.active_requests, busy=eng.has_unfinished(),
                stats=eng.prefix_cache_stats())


def _evict_all(eng):
    while eng._cache._entries:
        eng._cache.evict_lru(eng._decref, eng._demote_entry)


# ------------------------------------------------ the reference's tests ---

@pytest.mark.parametrize("n", [2, 4])
def test_tp_sharded_engine_identical_tokens(params, n):
    """tests/test_llm.py:196-214: the tp-sharded engine's tokens equal the
    single-device engine's, and the JAX tp engine's. Each position holds
    its share: heads, kv heads and hidden units split n ways, the pool
    split over kv heads, nothing else on the engine."""
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [21, 22]]
    kw = dict(max_batch=2, max_len=64, seed=0)
    ref = LLMEngine(CFG, params[1], device="cpu", **kw)
    out_ref = ref.generate(prompts, SamplingParams(max_tokens=8))
    jeng, shd = _pair(params, n, **kw)
    assert "tp" in str(jeng.params["layers"]["attn"]["wq"].sharding.spec)
    assert shd.params is None and len(shd._shards) == n
    L, E, H, D = params[1]["layers"]["attn"]["wq"].shape
    KV, M = CFG.num_kv_heads, CFG.intermediate_size
    for p in shd._shards:
        assert tuple(p["layers"]["attn"]["wq"].shape) == (L, E, H // n, D)
        assert tuple(p["layers"]["attn"]["wo"].shape) == (L, H // n, D, E)
        assert tuple(p["layers"]["mlp"]["w_down"].shape) == (L, M // n, E)
        assert p["embed"] is params[1]["embed"]      # replicated, no copy
    assert [tuple(pk.shape) for pk in shd._pk] \
        == [tuple(ref._pk[0].shape[:3]) + (KV // n, D)] * n
    assert sum(pk.nbytes for pk in shd._pk) == ref._pk[0].nbytes
    out_shd = shd.generate(prompts, SamplingParams(max_tokens=8))
    assert out_shd == out_ref
    assert jeng.generate(prompts, JaxSP(max_tokens=8)) == out_ref


def test_pd_kv_transfer_across_sharding_layouts(params):
    """tests/test_llm.py:235-257: unsharded prefill -> tp-sharded decode
    and back, on both packages; the blobs are full (L, S, KV, D) and the
    port's agree with JAX's."""
    jmesh, mesh = _meshes(2)
    prompt = [4, 8, 15, 16, 23]
    got = {}
    for pkg, cls, cfg, p, m, kw in (
            ("jax", JaxEngine, JCFG, params[0], jmesh, {}),
            ("port", LLMEngine, CFG, params[1], mesh, dict(device="cpu"))):
        sp = (JaxSP if pkg == "jax" else SamplingParams)(max_tokens=6)
        expect = cls(cfg, p, max_batch=1, max_len=64, seed=0,
                     **kw).generate([prompt], sp)[0]
        pre = cls(cfg, p, max_batch=1, max_len=64, seed=0, **kw)
        dec_shd = cls(cfg, p, max_batch=2, max_len=64, seed=0, mesh=m, **kw)
        blob, first = pre.prefill_only(prompt, sp)
        assert dec_shd.decode_from(blob, first, sp) == expect
        pre_shd = cls(cfg, p, max_batch=1, max_len=64, seed=0, mesh=m, **kw)
        dec = cls(cfg, p, max_batch=2, max_len=64, seed=0, **kw)
        blob2, first2 = pre_shd.prefill_only(prompt, sp)
        assert dec.decode_from(blob2, first2, sp) == expect
        assert first2 == first
        got[pkg] = (expect, blob, blob2)
    assert got["port"][0] == got["jax"][0]
    for g, w in zip(got["port"][1:], got["jax"][1:]):
        for name in ("k", "v"):
            assert tuple(g[name].shape) == (CFG.num_layers, len(prompt),
                                            CFG.num_kv_heads, CFG.head_dim_)
            np.testing.assert_allclose(_np(g[name]), _np(w[name]), **TOL)
    # The sharded prefill's blob is the unsharded one's within f32 order.
    np.testing.assert_allclose(_np(got["port"][2]["k"]),
                               _np(got["port"][1]["k"]), **TOL)


# -------------------------------------------------- features under tp=2 ---

def test_prefix_hit_demotion_and_promotion_match_jax(params):
    """On tp=2 engines: a miss, a hit on two shared pages, every entry
    demoted (each position's kv heads joined into one host entry), a
    promoted hit (split back over the positions); tokens and
    ``prefix_cache_stats()`` equal JAX's at every point, and the promoted
    hit's tokens the resident hit's."""
    prefix = list(range(5, 25))                       # 2 full pages of 8
    runs = []
    for eng in _pair(params, 2, max_batch=2, max_len=64, seed=0, page_size=8,
                     kv_pages=12, prefix_cache=True):
        log = []
        for prompt in (prefix + [30, 31], prefix + [40, 41, 42]):
            log.append(eng.generate([prompt], _sp(eng, max_tokens=5))[0])
            log.append(eng.prefix_cache_stats())
        _evict_all(eng)
        log.append(eng.prefix_cache_stats())
        log.append(eng.generate([prefix + [40, 41, 42]],
                                _sp(eng, max_tokens=5))[0])
        log.append(eng.prefix_cache_stats())
        runs.append(log)
    assert runs[1] == runs[0]
    log = runs[1]
    assert log[3]["hits"] == 1 and log[3]["hit_pages"] == 2
    assert log[4]["demoted_pages"] > 0 and log[4]["entries"] == 0
    assert log[6]["promoted_pages"] > 0 and log[5] == log[2]


def test_chunked_prefill_and_cancellation_match_jax(params):
    """On tp=2 engines: a prefix hit whose suffix is longer than a chunk
    advances by suffix chunks beside a shipped (P/D) request and a request
    cancelled mid-chunk; tick events, cache stats and page accounting equal
    JAX's."""
    base = _prompt(40, seed=7)
    first, second = base + _prompt(5, seed=8), base + _prompt(30, seed=9)
    kw = dict(max_batch=3, max_len=128, seed=0, page_size=8,
              prefill_chunk=16, prefix_cache=True)
    jpre = JaxEngine(JCFG, params[0], max_batch=1, max_len=128, seed=0,
                     page_size=8)
    blob, tok = jpre.prefill_only(_prompt(12, seed=10), JaxSP(max_tokens=6))
    np_blob = {"k": np.asarray(blob["k"]), "v": np.asarray(blob["v"]),
               "len": blob["len"]}
    runs = []
    for eng, b in zip(_pair(params, 2, **kw), (blob, np_blob)):
        ticks = [eng.generate([first], _sp(eng, max_tokens=4))]
        eng.add_request(second, _sp(eng, max_tokens=6))
        eng.add_external_request(b, tok, _sp(eng, max_tokens=6))
        doomed = eng.add_request(_prompt(50, seed=11), _sp(eng, max_tokens=6))
        while eng.has_unfinished():
            eng.step()
            ticks.append((eng.take_tick_events(), sorted(eng._prefilling)))
            if any(r.req_id == doomed for r in eng._prefilling.values()):
                ticks.append(("cancel", eng.cancel_request(doomed),
                              _accounting(eng)))
        runs.append((ticks, _accounting(eng)))
    assert runs[1] == runs[0]
    ticks, end = runs[1]
    assert ("cancel", True) in [t[:2] for t in ticks if t[0] == "cancel"]
    assert end["stats"]["hits"] >= 1 and not end["busy"]


def test_paged_requests_match_jax(params):
    """On tp=2 engines: prefill_paged of a 100-token context into four
    parts, decode_paged through a window of 2 (smaller than the part count,
    so it refetches); the parts stay full (L, span, KV, D) and agree with
    JAX's, and the tokens, page accounting and window counters are
    equal."""
    prompt = _prompt(100, seed=5)
    paged = dict(max_batch=1, max_len=64, page_size=16, kv_pages=4, seed=0)
    results = []
    for pre, dec in zip(_pair(params, 2, **paged),
                        _pair(params, 2, kv_gather_window=2, **paged)):
        sp = _sp(pre, max_tokens=6)
        handoff = pre.prefill_paged(prompt, sp, span=32)
        out = dec.decode_paged(handoff, sp)
        st = dict(dec.kv_gather_stats())
        del st["wait_s"]
        results.append((out, handoff, dec.kv_pages_free(), st))
    (jout, jh, jfree, jst), (out, h, free, st) = results
    assert (out, free, st) == (jout, jfree, jst)
    assert st["refetches"] > 0 and free == paged["kv_pages"]
    assert (h["len"], h["first"]) == (jh["len"], jh["first"])
    for g, w in zip(h["parts"], jh["parts"]):
        assert g["span"] == w["span"]
        for name in ("k", "v"):
            assert g["handle"][name].shape[2] == CFG.num_kv_heads
            np.testing.assert_allclose(_np(g["handle"][name]),
                                       _np(w["handle"][name]), **TOL)
    # The same handoff decoded by an unsharded engine gives the same tokens.
    flat = LLMEngine(CFG, params[1], device="cpu", kv_gather_window=2,
                     **paged)
    assert flat.decode_paged(h, SamplingParams(max_tokens=6)) == out


@pytest.mark.parametrize("n", [2, 4])
def test_forward_under_a_tp_mesh_matches_jax(params, n):
    """forward() under a tp mesh against JAX's forward under the same mesh
    (its params placed by tree_shardings, the default rules, which also
    split the vocabulary) and against the port's unsharded forward."""
    jmesh, mesh = _meshes(n)
    toks = np.random.default_rng(n).integers(0, CFG.vocab_size, (2, 19))
    jp = jax.device_put(params[0], jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh))
    want = np.asarray(jax.jit(lambda p, t: jax_forward(p, t, JCFG, jmesh))(
        jp, jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        got = forward(params[1], toks, CFG, mesh, device="cpu").numpy()
        plain = forward(params[1], toks, CFG, device="cpu").numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


def test_each_position_runs_kernel_1_over_its_heads(params, monkeypatch):
    """A full prefill calls the flash kernel's wrapper once per position and
    layer, on the position's Hq/n and Hkv/n heads; a prefix hit's suffix
    and a decode step call it never."""
    calls = []
    real = torch_engine.flash_attention

    def spy(q, k, v, causal):
        calls.append((q.shape[2], k.shape[2]))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(torch_engine, "flash_attention", spy)
    _, eng = _pair(params, 2, max_batch=1, max_len=64, seed=0, page_size=8,
                   prefix_cache=True)
    prefix = _prompt(16, seed=1)
    eng.add_request(prefix + [3, 4], SamplingParams(max_tokens=2))
    eng.step()
    assert calls == [(CFG.num_heads // 2, CFG.num_kv_heads // 2)] \
        * (2 * CFG.num_layers)
    calls.clear()
    while eng.has_unfinished():
        eng.step()
    eng.generate([prefix + [5, 6, 7]], SamplingParams(max_tokens=3))
    assert calls == [] and eng.prefix_cache_stats()["hits"] == 1


def test_tp_engine_errors_match_jax(params):
    """The kv-heads ValueError is JAX's word for word; an engine whose
    device is not of its mesh's type raises; rules= is used only with a tp
    mesh, as in JAX."""
    jmesh = jax_build_mesh(JaxMeshSpec(tp=8), devices=jax.devices()[:8])
    mesh = build_mesh(MeshSpec(tp=8), devices=[CPU] * 8)
    with pytest.raises(ValueError) as want:
        JaxEngine(JCFG, params[0], mesh=jmesh)
    with pytest.raises(ValueError) as got:
        LLMEngine(CFG, params[1], device="cpu", mesh=mesh)
    assert str(got.value) == str(want.value)
    assert "num_kv_heads=4 not divisible by tp=8" in str(got.value)
    eng = LLMEngine(CFG, params[1], device="cpu", max_len=64, rules=object())
    assert eng.tp_degree == 1 and eng.params is params[1]
    big = dataclasses.replace(CFG, num_heads=16, num_kv_heads=8)
    assert LLMEngine(big, device="cpu", max_len=32,
                     mesh=mesh)._pk[0].shape[3] == 1


def test_replica_on_a_tp_mesh_matches_the_jax_replica(params):
    """EngineReplica passes a tp mesh to its engine: generate's tokens equal
    the JAX replica's on a tp=2 mesh of the same params."""
    jmesh, mesh = _meshes(2)
    prompts = [_prompt(40, seed=5), _prompt(11, seed=6)]

    async def run(er):
        return [(await er.generate(p))["tokens"] for p in prompts]

    def script(er):
        return asyncio.run(asyncio.wait_for(run(er), SCRIPT_TIMEOUT_S))
    port = EngineReplica(CFG, params[1], max_len=128, device="cpu",
                         max_tokens=6, mesh=mesh)
    assert port.engine.tp_degree == 2
    want = script(JaxReplica(JCFG, max_len=128, max_tokens=6, mesh=jmesh))
    assert script(port) == want
