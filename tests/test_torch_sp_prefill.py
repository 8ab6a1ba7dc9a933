"""Parity of ray_tpu_torch's sequence-parallel prefill with the JAX
package's on the CPU (the ports of tests/test_long_context.py:43-143).

JAX runs its ``shard_map`` programs on the conftest's 8 CPU devices; the
port runs with ``device="cpu"`` on a mesh that names the CPU n times. The
JAX engine's ``tiny`` params (f32) are carried across. Logits and KV agree
within 2e-4; greedy tokens, ``sp_stripes``, the prefix cache's counters and
the ``ValueError`` messages are equal.
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
from ray_tpu.llm.sequence_parallel import sp_mesh as jax_sp_mesh
from ray_tpu.llm.sequence_parallel import sp_prefill_fn as jax_sp_prefill_fn
from ray_tpu.llm.sequence_parallel import \
    sp_stripe_pages as jax_sp_stripe_pages
from ray_tpu.llm.sequence_parallel import \
    sp_suffix_prefill_fn as jax_sp_suffix_prefill_fn
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu_torch.llm import EngineReplica, LLMEngine, SamplingParams
from ray_tpu_torch.llm.engine import _prefill_fn
from ray_tpu_torch.llm.sequence_parallel import (replicate_params,
                                                 sp_prefill_fn,
                                                 sp_stripe_pages,
                                                 sp_suffix_prefill_fn)
from ray_tpu_torch.models import PRESETS, from_jax_params
from ray_tpu_torch.parallel import MeshSpec, build_mesh

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)
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


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size,
                                                n).tolist()


def _cpu_mesh(n):
    return build_mesh(MeshSpec(sp=n), devices=[CPU] * n)


def _pair(params, **kw):
    """A JAX engine (its own sp mesh on the 8 CPU devices) and a port
    engine over the same params."""
    jp, tp = params
    return (JaxEngine(JCFG, jp, **kw),
            LLMEngine(CFG, tp, device="cpu", **kw))


# ------------------------------------------------------------- SP parity ---

def _plain_prefill(params, toks, length):
    """The port's unsharded _prefill_fn: (logits, ks, vs) as tensors."""
    logits, ks, vs = _prefill_fn([params], torch.from_numpy(toks), length,
                                 CFG)
    return logits, ks[0], vs[0]


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sp_prefill_fn_parity(params, degree, strategy):
    """sp_prefill_fn against JAX's and against the port's _prefill_fn:
    logits and the real positions' KV, at odd lengths whose padded tail
    crosses shard boundaries."""
    jp, tp = params
    jmesh, mesh = jax_sp_mesh(degree), _cpu_mesh(degree)
    rep = replicate_params(tp, mesh)
    for S, Sb in ((37, 64), (111, 128)):
        toks = np.zeros((1, Sb), np.int64)
        toks[0, :S] = _prompt(S, seed=S)
        want = jax.jit(lambda p, t, n: jax_sp_prefill_fn(
            p, t, n, JCFG, jmesh, strategy))(
                jp, jnp.asarray(toks, jnp.int32), S)
        got = sp_prefill_fn(rep, torch.from_numpy(toks), S, CFG, mesh,
                            strategy)
        plain = _plain_prefill(tp, toks, S)
        for g, w, p in zip(got, want, plain):
            g, w, p = g.numpy(), np.asarray(w), p.numpy()
            if g.ndim > 1:              # padded-tail rows are garbage
                g, w, p = g[:, :S], w[:, :S], p[:, :S]
            np.testing.assert_allclose(g, w, **TOL)
            np.testing.assert_allclose(g, p, **TOL)


@pytest.mark.parametrize("degree", [2, 4])
def test_sp_suffix_prefill_fn_matches_jax(params, degree):
    """The suffix against 3 resident prefix pages (24 tokens of a page-8
    pool holding a real prefill), seeded ring over a 19-token suffix."""
    jp, tp = params
    page, pre, suf, Sb = 8, 24, 19, 32
    prompt = _prompt(pre + suf, seed=degree)
    toks = np.zeros((1, 32), np.int64)
    toks[0, :pre] = prompt[:pre]
    _, pk, pv = _plain_prefill(tp, toks, pre)
    pool_k = torch.zeros((CFG.num_layers, 9, page) + pk.shape[2:])
    pool_v = torch.zeros_like(pool_k)
    pages = np.array([3, 5, 1, 0, 0, 0, 0, 0], np.int64)
    for i, p in enumerate(pages[:3]):
        pool_k[:, p] = pk[:, i * page:(i + 1) * page]
        pool_v[:, p] = pv[:, i * page:(i + 1) * page]
    stoks = np.zeros((1, Sb), np.int64)
    stoks[0, :suf] = prompt[pre:]
    want = jax.jit(lambda *a: jax_sp_suffix_prefill_fn(
        *a, suf, JCFG, page, jax_sp_mesh(degree)))(
            jp, jnp.asarray(pool_k.numpy()), jnp.asarray(pool_v.numpy()),
            jnp.asarray(pages, jnp.int32), jnp.asarray(stoks, jnp.int32),
            pre)
    mesh = _cpu_mesh(degree)
    got = sp_suffix_prefill_fn(replicate_params(tp, mesh), pool_k, pool_v,
                               torch.from_numpy(pages),
                               torch.from_numpy(stoks), pre, suf, CFG, page,
                               mesh)
    full = np.zeros((1, 64), np.int64)
    full[0, :pre + suf] = prompt
    plain = _plain_prefill(tp, full, pre + suf)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[0].numpy(), plain[0].numpy(), **TOL)
    for g, w, p in zip(got[1:], want[1:], plain[1:]):
        np.testing.assert_allclose(g.numpy()[:, :suf],
                                   np.asarray(w)[:, :suf], **TOL)
        np.testing.assert_allclose(g.numpy()[:, :suf],
                                   p.numpy()[:, pre:pre + suf], **TOL)


@pytest.mark.parametrize("degree,strategy",
                         [(1, "ring"), (2, "ring"), (4, "ulysses")])
def test_engine_sp_generate_parity(params, degree, strategy):
    """Greedy tokens through the SP engine equal the sp=1 engine's and the
    JAX SP engine's; the SP prefill's KV installs into the pool that
    decode reads. sp_stripes equal JAX's and cover the request's pages."""
    prompts = [_prompt(40), _prompt(23, seed=1)]
    base = LLMEngine(CFG, params[1], max_batch=2, max_len=128,
                     device="cpu")
    expect = base.generate(prompts, SamplingParams(max_tokens=6))
    jeng, eng = _pair(params, max_batch=2, max_len=128, sp_degree=degree,
                      sp_strategy=strategy)
    assert eng.sp_degree == degree and (eng.mesh is None) == (degree == 1)
    got = eng.generate(prompts, SamplingParams(max_tokens=6))
    assert got == expect
    assert got == jeng.generate(prompts, JaxSP(max_tokens=6))
    jeng2, eng2 = _pair(params, max_batch=1, max_len=128, sp_degree=degree,
                        sp_strategy=strategy, page_size=8)
    stripes = []
    for e, sp in ((jeng2, JaxSP), (eng2, SamplingParams)):
        rid = e.add_request(_prompt(40), sp(max_tokens=6))
        e.step()
        stripes.append((e._requests[rid].sp_stripes,
                        [int(p) for p in e._tables[0][:5]]))
    assert stripes[0] == stripes[1]
    got_stripes, pages = stripes[1]
    if degree == 1:
        assert got_stripes is None
    else:
        assert len(got_stripes) == degree
        assert sorted(p for s in got_stripes for p in s) == sorted(pages)


def test_engine_sp_prefix_cache_suffix_parity(params):
    """A prefix-cache hit under SP: the second request's suffix prefill runs
    sequence-parallel (a ring seeded by the resident prefix) and still
    skips the shared pages; tokens equal the sp=1 engine's, and the cache
    counters, the b"sp2" tag and the suffix's stripes equal JAX's."""
    shared = _prompt(32, seed=7)
    p1 = shared + _prompt(9, seed=8)
    p2 = shared + _prompt(13, seed=9)
    kw = dict(max_batch=2, max_len=128, page_size=16, prefix_cache=True)
    base = LLMEngine(CFG, params[1], device="cpu", **kw)
    e1 = base.generate([p1], SamplingParams(max_tokens=5))
    e2 = base.generate([p2], SamplingParams(max_tokens=5))
    jeng, eng = _pair(params, sp_degree=2, **kw)
    assert eng._cache.tag == jeng._cache.tag == b"sp2"
    for e, sp in ((jeng, JaxSP), (eng, SamplingParams)):
        assert e.generate([p1], sp(max_tokens=5)) == e1
        rid = e.add_request(p2, sp(max_tokens=5))
        e.step()
        req = e._requests[rid]
        assert req.prefix_len == 32
        stripes = req.sp_stripes
        while e.has_unfinished():
            e.step()
        assert req.out == e2[0]
        if e is jeng:
            want = (stripes, jeng.prefix_cache_stats())
    assert (stripes, eng.prefix_cache_stats()) == want
    st = eng.prefix_cache_stats()
    assert st["hits"] >= 1 and st["hit_pages"] >= 2


def test_sp_engine_chunked_prefill_matches_sp1(params):
    """Chunked prefill under SP: the first chunk is an SP prefill, the rest
    SP suffixes; tokens equal the sp=1 chunked engine's, and no stripes."""
    prompt = _prompt(70, seed=4)
    kw = dict(max_batch=1, max_len=128, page_size=8, prefill_chunk=24)
    want = LLMEngine(CFG, params[1], device="cpu", **kw).generate(
        [prompt], SamplingParams(max_tokens=5))
    eng = LLMEngine(CFG, params[1], device="cpu", sp_degree=4, **kw)
    rid = eng.add_request(prompt, SamplingParams(max_tokens=5))
    req = eng._requests[rid]
    while eng.has_unfinished():
        eng.step()
    assert [req.out] == want and req.sp_stripes is None


def test_sp_engine_rejects_bad_layouts_with_the_reference_messages():
    def raised(fn):
        with pytest.raises(ValueError) as info:
            fn()
        return str(info.value)
    mesh4 = _cpu_mesh(4)
    for kw, jkw in (
            (dict(sp_degree=3), {}),
            (dict(max_len=90, sp_degree=4), {}),
            (dict(sp_degree=8, sp_strategy="ulysses"), {}),
            (dict(sp_degree=2, sp_strategy="zigzag"), {}),
            (dict(sp_degree=2, mesh=mesh4), dict(mesh=jax_sp_mesh(4)))):
        want = raised(lambda: JaxEngine(JCFG, **{**kw, **jkw}))
        got = raised(lambda: LLMEngine(CFG, device="cpu", **kw))
        assert got == want, kw


def test_engine_adopts_the_mesh_sp_axis_and_the_config_degree(params):
    eng = LLMEngine(CFG, params[1], max_len=64, mesh=_cpu_mesh(4),
                    device="cpu")
    assert eng.sp_degree == 4 and eng._cache is None
    eng = LLMEngine(dataclasses.replace(CFG, sp_degree=2), params[1],
                    max_len=64, device="cpu", prefix_cache=True)
    assert eng.sp_degree == 2 and eng._cache.tag == b"sp2"
    assert eng.mesh.shape["sp"] == 2
    assert eng._bucket(3) == 8
    eng8 = LLMEngine(CFG, params[1], max_len=64, sp_degree=16,
                     device="cpu")
    assert eng8._bucket(3) == 16


def test_sp_weights_are_not_copied_on_a_repeated_device(params):
    eng = LLMEngine(CFG, params[1], max_len=64, sp_degree=4, device="cpu")
    (dev, rep), = eng._sp_params.items()
    assert dev == CPU
    assert rep["embed"] is params[1]["embed"]
    assert rep["layers"]["attn"]["wq"] is params[1]["layers"]["attn"]["wq"]


def test_sp_engine_on_one_gpu_without_a_mesh_raises(monkeypatch):
    """sp_degree=2 on a machine with one GPU and no mesh: sp_mesh's
    ValueError, raised before anything is allocated on the card; the
    engine does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
        LLMEngine(CFG, sp_degree=2)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sp_stripe_pages_match_jax_over_a_grid(n_shards):
    pages = list(range(100, 140))
    for page in (8, 16, 64):
        for S in (1, 7, 8, 37, 64, 111, 128, 200):
            for padded in (None, max(8, 1 << (S - 1).bit_length())):
                if (padded or S) < n_shards:
                    continue            # no shard holds a whole token
                want = jax_sp_stripe_pages(pages, S, n_shards, page,
                                           padded=padded)
                assert sp_stripe_pages(pages, S, n_shards, page,
                                       padded=padded) == want


def test_replica_with_sp_degree_2_matches_the_sp1_replica(params):
    """EngineReplica passes mesh, sp_degree and sp_strategy to its engine:
    tokens equal the sp=1 replica's."""
    prompts = [_prompt(40, seed=5), _prompt(11, seed=6)]

    async def run(degree, **kw):
        er = EngineReplica(CFG, params[1], max_len=128, device="cpu",
                           max_tokens=6, **kw)
        assert er.engine.sp_degree == degree
        return [(await er.generate(p))["tokens"] for p in prompts]

    def script(coro):
        return asyncio.run(asyncio.wait_for(coro, SCRIPT_TIMEOUT_S))
    want = script(run(1))
    assert script(run(2, sp_degree=2)) == want
    assert script(run(4, mesh=_cpu_mesh(4),
                      sp_strategy="ulysses")) == want
