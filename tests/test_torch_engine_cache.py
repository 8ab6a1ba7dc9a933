"""Parity of ray_tpu_torch's prefix cache and KV demotion tier with the JAX
engine on the CPU.

The JAX engine's ``tiny`` params (f32) are carried across. Cache keys must
be byte-equal, ``_suffix_prefill_fn`` must agree within 1e-4, and the same
request sequence must give identical greedy tokens and an identical
``prefix_cache_stats()`` dict on both engines (the ports of
tests/test_llm_serving.py:90-140 and tests/test_memory_tiers.py:333-390).
"""

import collections
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.llm.engine import _KVDemoteStore as JaxDemoteStore
from ray_tpu.llm.engine import _PrefixCache as JaxPrefixCache
from ray_tpu.llm.engine import _suffix_prefill_fn as jax_suffix_prefill_fn
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu_torch import _config
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.llm import engine as torch_engine
from ray_tpu_torch.llm.engine import (_KVDemoteStore, _PrefixCache,
                                      _suffix_prefill_fn)
from ray_tpu_torch.models import PRESETS, from_jax_params

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
SMALL = dict(max_batch=2, max_len=64, seed=0, page_size=8)


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


def _gen(eng, prompt, max_tokens):
    sp = (JaxSP if isinstance(eng, JaxEngine) else SamplingParams)(
        max_tokens=max_tokens)
    return eng.generate([prompt], sp)[0]


def _evict_all(eng, demote: bool):
    hook = eng._demote_entry if demote else None
    while eng._cache._entries:
        eng._cache.evict_lru(eng._decref, hook)


# ------------------------------------------------------------ the cache ---

@pytest.mark.parametrize("tag", [b"", b"sp2"])
@pytest.mark.parametrize("page", [8, 64])
def test_prefix_cache_keys_match_jax_byte_for_byte(tag, page):
    prompt = np.random.default_rng(page).integers(0, 128256,
                                                  5 * page + 3).tolist()
    want = JaxPrefixCache(page, tag)._keys(prompt, 5)
    got = _PrefixCache(page, tag)._keys(prompt, 5)
    assert got == want
    assert len(set(got)) == 5 and all(len(k) == 16 for k in got)


def test_prefix_cache_lookup_insert_evict_match_jax():
    """The same calls on both caches give the same hits, pages, refcounts
    and counters, and evict_lru demotes before it drops the refs."""
    prompts = [list(range(1, 30)), list(range(1, 20)) + [99] * 10,
               list(range(1, 9)), [5] * 40, list(range(1, 30))]

    def run(cls):
        cache, refs, log = cls(8), collections.Counter(), []
        for i, prompt in enumerate(prompts):
            log.append(cache.lookup(prompt))
            cache.insert(prompt, [100 * i + j for j in range(8)],
                         lambda p: refs.update([p]))
        while cache.evict_lru(lambda p: log.append(("decref", p)),
                              lambda key, pages: log.append(
                                  ("demote", key, tuple(pages)))):
            pass
        return (log, dict(refs), cache.hits, cache.misses, cache.hit_pages,
                cache.evictions)

    got = run(_PrefixCache)
    assert got == run(JaxPrefixCache)
    # hits, misses: an 8-token prompt has no usable page and is neither
    assert got[2:4] == (2, 2)


# ----------------------------------------------------- suffix prefill fn ---

@pytest.mark.parametrize("prefix_pages,suffix_len,bucket",
                         [(1, 5, 8), (2, 13, 16), (3, 32, 32), (4, 1, 8),
                          (5, 20, 32)])
def test_suffix_prefill_fn_matches_jax(prefix_pages, suffix_len, bucket):
    page, per_slot, n_pages = 8, 8, 12
    jeng, teng = _pair(max_batch=1, max_len=64, seed=3, page_size=page)
    rng = np.random.default_rng(10 * prefix_pages + suffix_len)
    shape = (CFG.num_layers, n_pages, page, CFG.num_kv_heads, CFG.head_dim_)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    # The prefix pages, then pages of garbage that the mask must hide.
    pages = rng.permutation(np.arange(1, n_pages))[:per_slot].astype(np.int32)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :suffix_len] = rng.integers(1, CFG.vocab_size, suffix_len)
    prefix_len = prefix_pages * page
    want = jax_suffix_prefill_fn(jeng.params, jnp.asarray(pk),
                                 jnp.asarray(pv), jnp.asarray(pages),
                                 jnp.asarray(toks), prefix_len, suffix_len,
                                 JCFG, page)
    args = (torch.from_numpy(pages).long(), torch.from_numpy(toks).long(),
            prefix_len, suffix_len, CFG, page)
    def suffix():
        logits, ks, vs = _suffix_prefill_fn(
            [teng.params], [torch.from_numpy(pk)], [torch.from_numpy(pv)],
            *args)
        return logits, ks[0], vs[0]
    got = suffix()
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    # The garbage pages are masked: new garbage changes no bit.
    garbage = pages[prefix_pages:]
    pk[:, garbage], pv[:, garbage] = pk[:, garbage] * 7 + 3, -pv[:, garbage]
    again = suffix()
    assert all(torch.equal(a, g) for a, g in zip(again, got))


# ------------------------------------------------- the engine's cache path ---

def test_prefix_cache_hit_parity_and_accounting(monkeypatch):
    """A shared-prefix request skips the shared pages' prefill, tokens equal
    the JAX engine's (cached and not), and the stats dicts are equal."""
    prefix = list(range(5, 25))              # 2 full pages of 8
    pA, pB = prefix + [30, 31], prefix + [40, 41, 42]
    jref, _ = _pair(**SMALL)
    jeng, teng = _pair(prefix_cache=True, **SMALL)
    suffix_calls = []
    real = torch_engine._suffix_prefill_fn

    def spy(params, pk, pv, pages, tokens, prefix_len, *rest):
        suffix_calls.append(prefix_len)
        return real(params, pk, pv, pages, tokens, prefix_len, *rest)
    monkeypatch.setattr(torch_engine, "_suffix_prefill_fn", spy)
    for prompt in (pA, pB, pA):
        want = _gen(jeng, prompt, 5)
        assert _gen(teng, prompt, 5) == want == _gen(jref, prompt, 5)
        assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    st = teng.prefix_cache_stats()
    assert st["hits"] == 2 and st["hit_pages"] == 4 and st["misses"] == 1
    # B borrowed A's 2 prefix pages; A's rerun skipped 16 tokens.
    assert suffix_calls == [16, 16]
    assert st["free_pages"] + st["allocated_pages"] == teng.kv_pages_total


def test_prefix_cache_evicts_under_pool_pressure():
    """A 4-page pool with one cached page per retired request: LRU entries
    evict (into the demotion tier) so admissions keep fitting."""
    jeng, teng = _pair(kv_pages=4, prefix_cache=True, **SMALL)
    for i in range(6):
        prompt = [i * 7 + 1, i * 7 + 2] * 6
        assert _gen(teng, prompt, 4) == _gen(jeng, prompt, 4)
        assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    st = teng.prefix_cache_stats()
    assert st["evictions"] >= 1 and st["demoted_pages"] >= 1, st
    assert st["free_pages"] + st["allocated_pages"] == 4


def test_no_cache_requests_bypass_the_cache():
    jeng, teng = _pair(prefix_cache=True, **SMALL)
    prompt = list(range(1, 20))
    for eng, sp in ((jeng, JaxSP), (teng, SamplingParams)):
        for _ in range(2):
            rid = eng.add_request(prompt, sp(max_tokens=3), no_cache=True)
            while eng.has_unfinished():
                eng.step()
            assert rid not in eng._requests
    st = teng.prefix_cache_stats()
    assert st == jeng.prefix_cache_stats()
    assert st["entries"] == st["hits"] == st["misses"] == 0


# ------------------------------------------------------------ KV demotion ---

def test_kv_demote_promote_token_parity():
    """Evicted prefix pages demote to host memory and promote back on
    reuse, token-exact, with the JAX engine's counters at every point."""
    prompt = list(range(1, 33))                      # 4 full pages
    stats = []
    for eng in _pair(kv_pages=12, prefix_cache=True, **SMALL):
        first = _gen(eng, prompt, 4)
        _evict_all(eng, demote=True)
        mid = eng.prefix_cache_stats()
        again = _gen(eng, prompt, 4)
        stats.append((first, mid, again, eng.prefix_cache_stats()))
    assert stats[1] == stats[0]
    first, mid, again, end = stats[1]
    assert mid["demoted_pages"] > 0 and mid["entries"] == 0
    assert end["promoted_pages"] > 0, "reuse must promote, not re-prefill"
    assert again == first


def test_kv_demote_overflows_to_files_and_promotes(tmp_path):
    """Past a 1-byte host window every demoted entry overflows to a
    kvdemote-* file and still promotes token-exact."""
    stats = []
    for eng, store, sub in zip(_pair(kv_pages=12, prefix_cache=True,
                                     **SMALL),
                               (JaxDemoteStore, _KVDemoteStore),
                               ("jax", "port")):
        eng._demote = store(1, str(tmp_path / sub))
        prompt = list(range(1, 33))
        first = _gen(eng, prompt, 4)
        _evict_all(eng, demote=True)
        mid = eng.prefix_cache_stats()
        assert any(f.startswith("kvdemote-")
                   for f in os.listdir(tmp_path / sub))
        again = _gen(eng, prompt, 4)
        stats.append((first, mid, again, eng.prefix_cache_stats()))
    assert stats[1] == stats[0]
    first, mid, again, end = stats[1]
    assert mid["demoted_disk_entries"] > 0 and mid["demoted_disk_spills"] > 0
    assert mid["demoted_host_bytes"] == 0
    assert again == first and end["promoted_pages"] > 0


def test_bf16_file_entry_promotes_in_the_port_and_raises_in_jax(tmp_path):
    """A reference fault the port does not copy: on a bf16 ``tiny``, an
    entry that overflowed to a file cannot be promoted by the JAX engine
    (np.savez keeps ml_dtypes bf16 as void, and jnp.asarray raises
    ValueError), while the port promotes it with the tokens of its own
    resident hit."""
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    jeng = JaxEngine(jcfg, kv_pages=12, prefix_cache=True, **SMALL)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             "cpu")
    teng = LLMEngine(cfg, params, device="cpu", kv_pages=12,
                     prefix_cache=True, **SMALL)
    prompt = list(range(1, 33))                      # 4 full pages
    runs = {}
    for eng, store, sub in ((jeng, JaxDemoteStore, "jax"),
                            (teng, _KVDemoteStore, "port")):
        eng._demote = store(1, str(tmp_path / sub))  # every entry to a file
        miss = _gen(eng, prompt, 4)
        hit = _gen(eng, prompt, 4)
        _evict_all(eng, demote=True)
        assert eng.prefix_cache_stats()["demoted_disk_entries"] == 4
        runs[sub] = (miss, hit)
    with pytest.raises(ValueError, match="No cast function"):
        _gen(jeng, prompt, 4)
    promoted = _gen(teng, prompt, 4)
    stats = teng.prefix_cache_stats()
    assert stats["promoted_pages"] == 3 and stats["hits"] == 2
    assert promoted == runs["port"][1]


def test_kv_pool_squeeze_parks_and_restores_pages():
    outs = []
    for eng in _pair(kv_pages=16, prefix_cache=True, **SMALL):
        total_free = len(eng._free_pages)
        eng.apply_pool_pressure(0.25)
        assert eng._ballast_pages and len(eng._free_pages) < total_free
        outs.append((_gen(eng, [1, 2, 3, 4], 3),
                     eng.prefix_cache_stats()))
        eng.apply_pool_pressure(1.0)
        assert not eng._ballast_pages
        assert len(eng._free_pages) + len(eng._page_refs) == eng.n_pages - 1
    assert outs[1] == outs[0]
    assert outs[1][1]["ballast_pages"] == 12


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_demote_store_file_round_trip_is_bit_exact(tmp_path, dtype):
    store = _KVDemoteStore(0, str(tmp_path))         # every put overflows
    gen = torch.Generator().manual_seed(0)
    k = torch.randn((2, 3, 8, 4, 16), generator=gen).to(dtype)
    v = torch.randn((2, 3, 8, 4, 16), generator=gen).to(dtype)
    k[0, 0, 0, 0, :3] = torch.tensor([float("inf"), float("nan"), -0.0])
    store.put(b"key", k, v, 3)
    assert store.stats()["demoted_disk_entries"] == 1
    assert [f for f in os.listdir(tmp_path) if f.startswith("kvdemote-")]
    part = store.get(b"key")
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for got, want in ((part["k"], k), (part["v"], v)):
        assert got.dtype == dtype
        assert torch.equal(got.view(bits), want.view(bits))
    assert part["len"] == 3 and not os.listdir(tmp_path)
    assert store.stats()["promoted_pages"] == 3 and len(store) == 0


def test_demote_store_drops_an_entry_whose_write_fails(tmp_path):
    """A spill directory that cannot be made drops the entry, as the JAX
    store does: the same stats, and nothing to promote."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    spill_dir = str(blocker / "kv")
    k = np.ones((2, 1, 8, 4, 16), np.float32)
    port, ref = _KVDemoteStore(1, spill_dir), JaxDemoteStore(1, spill_dir)
    port.put(b"key", torch.from_numpy(k), torch.from_numpy(k), 1)
    ref.put(b"key", k, k, 1)
    assert port.stats() == ref.stats()
    assert port.get(b"key") is None and len(port) == 0


def test_demotion_settings_match_the_reference(monkeypatch, tmp_path):
    """The port's copy of the settings: the reference's types and
    defaults, and the same RAY_TPU_<name> overrides read the same way."""
    from ray_tpu._private.config import _REGISTRY, Config
    for name, (typ, default) in _config._SETTINGS.items():
        assert _REGISTRY[name][:2] == (typ, default)
    for env in ({"kv_cache_demotion_enabled": "0",
                 "kv_demoted_bytes_limit": "1234"},
                {"kv_cache_demotion_enabled": "Yes",
                 "object_spill_dir": str(tmp_path)}):
        for name in _config._SETTINGS:
            monkeypatch.delenv(f"RAY_TPU_{name}", raising=False)
        for name, value in env.items():
            monkeypatch.setenv(f"RAY_TPU_{name}", value)
        ref = Config()
        for name in _config._SETTINGS:
            assert _config.setting(name) == getattr(ref, name)
        eng = LLMEngine(CFG, device="cpu", prefix_cache=True)
        if env["kv_cache_demotion_enabled"] == "0":
            assert eng._demote is None
        else:
            assert eng._demote.spill_dir == str(tmp_path)
            assert eng._demote.byte_limit == 256 * 1024 * 1024
    assert LLMEngine(CFG, device="cpu")._demote is None   # no cache
