"""Parity of ray_tpu_torch's engine on the serving meshes beside tp alone
and sp alone with the JAX package's on the CPU: sp x tp (ring and
Ulysses), pp, pp x tp, dp and fsdp, dp or fsdp beside tp, pp or sp
(replicas of a split layout), and pp beside sp (with tp under
Ulysses).

JAX places its engine's params and pool on a mesh of the conftest's CPU
devices by its rules (GSPMD: layers over pp, heads over tp, replicated
over dp and fsdp) and runs its sequence-parallel prefill with its heads
over tp; the port runs on a mesh that names the CPU n times (a position
is not a device), each position holding its layers, heads, kv heads and
MLP hidden units, one replica per distinct placement of the dp x fsdp
coordinates (two where the second replica's positions name the CPU
"cpu:0"). The JAX engine's ``tiny`` params (f32) are carried across. Greedy tokens,
tick events, cache counters and page accounting are equal; logits and KV
blobs agree within 1e-4 (f32 sums in another order).
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.llm.serving import EngineReplica as JaxReplica
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu_torch.llm import EngineReplica, LLMEngine, SamplingParams
from ray_tpu_torch.models import PRESETS, from_jax_params
from ray_tpu_torch.parallel import MeshSpec, build_mesh

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
# A replica's whole script: generous, so that a stuck wait fails with the
# test's name instead of eating the suite's time limit.
SCRIPT_TIMEOUT_S = 120.0
# name: (mesh spec, SP strategy); the strategy matters only under sp.
LAYOUTS = {"sp2tp2-ring": (dict(sp=2, tp=2), "ring"),
           "sp2tp2-ulysses": (dict(sp=2, tp=2), "ulysses"),
           "pp2": (dict(pp=2), "ring"), "pp2tp2": (dict(pp=2, tp=2), "ring"),
           "dp2": (dict(dp=2), "ring"), "fsdp2": (dict(fsdp=2), "ring"),
           # Replicas of a split layout, two on the CPU's two names.
           "dp2tp2": (dict(dp=2, tp=2), "ring"),
           "fsdp2tp2": (dict(fsdp=2, tp=2), "ring"),
           "dp2pp2": (dict(dp=2, pp=2), "ring"),
           "dp2sp2": (dict(dp=2, sp=2), "ring"),
           # Stages beside sequence shards.
           "pp2sp2": (dict(pp=2, sp=2), "ring"),
           "pp2sp2tp2": (dict(pp=2, sp=2, tp=2), "ulysses")}


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


def _meshes(layout):
    """JAX's mesh of the CPU devices, and the port's naming the CPU once
    per position; where dp or fsdp is beside another split axis, the
    second replica's positions name it "cpu:0", so the engine holds two
    replicas."""
    spec, _ = LAYOUTS[layout]
    n = MeshSpec(**spec).n_devices
    mesh = build_mesh(MeshSpec(**spec), devices=[CPU] * n)
    devices = [CPU] * n
    if len([a for a, s in spec.items() if s > 1]) > 1 and (
            "dp" in spec or "fsdp" in spec):
        devices = ["cpu:0" if c[1] + c[2] else CPU for c in mesh.coords()]
    return (jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:n]),
            build_mesh(MeshSpec(**spec), devices=devices))


def _pair(params, layout, **kw):
    """(JAX engine, port engine) on ``layout``'s meshes over the same
    params."""
    jmesh, mesh = _meshes(layout)
    strategy = LAYOUTS[layout][1]
    return (JaxEngine(JCFG, params[0], mesh=jmesh, sp_strategy=strategy,
                      **kw),
            LLMEngine(CFG, params[1], device="cpu", mesh=mesh,
                      sp_strategy=strategy, **kw))


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


def _ticks(eng, prompts, max_tokens):
    """Every step's tick events for ``prompts`` queued at once."""
    for p in prompts:
        eng.add_request(p, _sp(eng, max_tokens=max_tokens))
    out = []
    while eng.has_unfinished():
        eng.step()
        out.append(eng.take_tick_events())
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tokens_logits_and_blobs_match_jax(params, layout):
    """A wave of three prompts: tick events equal JAX's and the unsharded
    engine's; the prefill logits and a P/D blob agree with JAX's within
    1e-4; P/D across layouts (the mesh engine's blob decoded by an
    unsharded engine and the reverse) gives the unsharded tokens."""
    kw = dict(max_batch=3, max_len=64, seed=0, page_size=8)
    jeng, eng = _pair(params, layout, **kw)
    flat = LLMEngine(CFG, params[1], device="cpu", **kw)
    prompts = [_prompt(13, seed=1), _prompt(30, seed=2), _prompt(5, seed=3)]
    want = np.asarray(jeng._run_prefill(prompts[1])[0])
    np.testing.assert_allclose(_np(eng._run_prefill(prompts[1])[0]), want,
                               **TOL)
    ticks = _ticks(eng, prompts, 6)
    assert ticks == _ticks(jeng, prompts, 6) == _ticks(flat, prompts, 6)
    assert _accounting(eng) == _accounting(jeng)
    blob, first = eng.prefill_only(prompts[0], SamplingParams(max_tokens=6))
    jblob, jfirst = jeng.prefill_only(prompts[0], JaxSP(max_tokens=6))
    assert first == jfirst
    for name in ("k", "v"):
        assert tuple(blob[name].shape) == (CFG.num_layers, 13,
                                           CFG.num_kv_heads, CFG.head_dim_)
        np.testing.assert_allclose(_np(blob[name]), _np(jblob[name]), **TOL)
    fblob, ffirst = flat.prefill_only(prompts[0], SamplingParams(
        max_tokens=6))
    assert ffirst == first
    sp = SamplingParams(max_tokens=6)
    expect = flat.decode_from(fblob, ffirst, sp)
    assert flat.decode_from(blob, first, sp) == expect
    assert eng.decode_from(fblob, ffirst, sp) == expect


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefix_hit_demotion_and_promotion_match_jax(params, layout):
    """A miss, a hit on two shared pages, every entry demoted (the
    positions' layers and kv heads joined into one host entry), a
    promoted hit (split back over the positions); tokens and
    ``prefix_cache_stats()`` equal JAX's at every point, and the promoted
    hit's tokens the resident hit's."""
    prefix = list(range(5, 25))                       # 2 full pages of 8
    runs = []
    for eng in _pair(params, layout, max_batch=2, max_len=64, seed=0,
                     page_size=8, kv_pages=12, prefix_cache=True):
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


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_chunked_prefill_and_cancellation_match_jax(params, layout):
    """A prefix hit whose suffix is longer than a chunk advances by suffix
    chunks beside a shipped (P/D) request and a request cancelled
    mid-chunk; tick events, cache stats and page accounting equal
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
    for eng, b in zip(_pair(params, layout, **kw), (blob, np_blob)):
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


@pytest.mark.parametrize("layout", ["sp2tp2-ring", "pp2tp2", "dp2tp2",
                                    "fsdp2tp2", "dp2pp2", "dp2sp2",
                                    "pp2sp2", "pp2sp2tp2"])
def test_paged_requests_match_jax(params, layout):
    """prefill_paged of a 100-token context into four parts, decode_paged
    through a window of 2 (so it refetches); the parts stay full
    (L, span, KV, D) and agree with JAX's, and the tokens, page
    accounting and window counters are equal."""
    prompt = _prompt(100, seed=5)
    paged = dict(max_batch=1, max_len=64, page_size=16, kv_pages=4, seed=0)
    results = []
    for pre, dec in zip(_pair(params, layout, **paged),
                        _pair(params, layout, kv_gather_window=2, **paged)):
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
            np.testing.assert_allclose(_np(g["handle"][name]),
                                       _np(w["handle"][name]), **TOL)


def test_layouts_hold_their_shares(params):
    """What each position holds: under pp x tp its stage's L/pp layers and
    its heads, a pool of those layers and kv heads, the pools summing to
    the unsharded pool; under sp x tp the tp positions' pools at the first
    sp position; under dp on a mesh that names one device twice, one
    replica, holding the params as they are."""
    kw = dict(max_batch=1, max_len=64, seed=0, page_size=8)
    flat = LLMEngine(CFG, params[1], device="cpu", **kw)
    L, H, KV = CFG.num_layers, CFG.num_heads, CFG.num_kv_heads
    _, pp = _pair(params, "pp2tp2", **kw)
    assert pp.params is None and len(pp._shards) == 4
    for p in pp._shards:
        assert p["layers"]["attn"]["wq"].shape[:3] == (L // 2, CFG.hidden_size,
                                                       H // 2)
    assert [tuple(pk.shape[:1] + pk.shape[3:4]) for pk in pp._pk] == \
        [(L // 2, KV // 2)] * 4
    assert sum(pk.nbytes for pk in pp._pk) == flat._pk[0].nbytes
    _, sptp = _pair(params, "sp2tp2-ring", **kw)
    assert len(sptp._shards) == 2 and len(sptp._sp_params) == 4
    assert sum(pk.nbytes for pk in sptp._pk) == flat._pk[0].nbytes
    _, dp = _pair(params, "dp2", **kw)
    assert len(dp._reps) == 1 and dp._shards[0]["embed"] is params[1][
        "embed"]
    # Two distinct devices (the CPU under two names): two replicas, each
    # with its own pool, the first sampling.
    two = build_mesh(MeshSpec(dp=2), devices=["cpu", "cpu:0"])
    rep = LLMEngine(CFG, params[1], device="cpu", mesh=two, **kw)
    assert len(rep._reps) == 2 and len(rep._pk) == 2
    prompts = [_prompt(13, seed=1)]
    assert rep.generate(prompts, SamplingParams(max_tokens=6)) == \
        flat.generate(prompts, SamplingParams(max_tokens=6))
    assert torch.equal(rep._pk[0], rep._pk[1])
    # Replicas of split layouts: each a tp group, a pp x tp stack or an sp
    # group, its pools at its sp shard 0, every replica's equal.
    for layout, n_pos in (("dp2tp2", 2), ("fsdp2tp2", 2), ("dp2pp2", 2),
                          ("dp2sp2", 1)):
        _, eng = _pair(params, layout, **kw)
        assert (len(eng._reps), eng._n_pos) == (2, n_pos), layout
        assert len(eng._pk) == 2 * n_pos and len(eng._sp_reps) == 2
        assert [d.index for d in {p.device for p in eng._pk}] == [None]
        assert eng.generate(prompts, SamplingParams(max_tokens=6)) == \
            flat.generate(prompts, SamplingParams(max_tokens=6))
        for a, b in zip(eng._pk[:n_pos], eng._pk[n_pos:]):
            assert torch.equal(a, b)
    # Stages beside sequence shards: a pool per stage and tp position, of
    # its L/pp layers and kv heads; each stage's SP params its sp x tp
    # positions'.
    _, ppsp = _pair(params, "pp2sp2tp2", **kw)
    assert len(ppsp._shards) == 4 and len(ppsp._sp_params) == 8
    assert [tuple(pk.shape[:1] + pk.shape[3:4]) for pk in ppsp._pk] == \
        [(L // 2, KV // 2)] * 4
    assert sum(pk.nbytes for pk in ppsp._pk) == flat._pk[0].nbytes


@pytest.mark.parametrize("layout", ["dp2tp2", "pp2sp2"])
def test_replica_on_split_replicas_and_stages_matches_the_jax_replica(
        params, layout):
    """EngineReplica on dp x tp (two replicas) and pp x sp: generate's
    tokens equal the JAX replica's on the same mesh."""
    jmesh, mesh = _meshes(layout)
    prompts = [_prompt(40, seed=5), _prompt(11, seed=6)]

    async def run(er):
        return [(await er.generate(p))["tokens"] for p in prompts]

    def script(er):
        return asyncio.run(asyncio.wait_for(run(er), SCRIPT_TIMEOUT_S))
    port = EngineReplica(CFG, params[1], max_len=128, device="cpu",
                         max_tokens=6, mesh=mesh)
    assert len(port.engine._reps) == (2 if "dp" in layout else 1)
    want = script(JaxReplica(JCFG, max_len=128, max_tokens=6, mesh=jmesh))
    assert script(port) == want


@pytest.mark.parametrize("spec,cfg", [
    # Ulysses splits the kv heads over sp: 2 do not split over 4.
    (dict(dp=2, sp=4), dict(num_kv_heads=2)),
    # 2 layers do not split over 4 stages.
    (dict(pp=4, dp=2), {}),
    # 4 kv heads do not split over 8 tp positions.
    (dict(tp=8), {})])
def test_layouts_jax_refuses_the_port_refuses_alike(spec, cfg):
    """Where the JAX engine refuses a serving layout, the port raises the
    same exception type."""
    import dataclasses
    n = MeshSpec(**spec).n_devices
    jmesh = jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:n])
    mesh = build_mesh(MeshSpec(**spec), devices=[CPU] * n)
    kw = dict(max_batch=1, max_len=64, sp_strategy="ulysses")
    with pytest.raises(ValueError):
        JaxEngine(dataclasses.replace(JCFG, **cfg), mesh=jmesh, **kw)
    with pytest.raises(ValueError):
        LLMEngine(dataclasses.replace(CFG, **cfg), device="cpu", mesh=mesh,
                  **kw)


def test_replica_on_a_pp_mesh_matches_the_jax_replica(params):
    """EngineReplica passes a pp mesh to its engine: generate's tokens equal
    the JAX replica's on a pp=2 mesh of the same params."""
    jmesh, mesh = _meshes("pp2")
    prompts = [_prompt(40, seed=5), _prompt(11, seed=6)]

    async def run(er):
        return [(await er.generate(p))["tokens"] for p in prompts]

    def script(er):
        return asyncio.run(asyncio.wait_for(run(er), SCRIPT_TIMEOUT_S))
    port = EngineReplica(CFG, params[1], max_len=128, device="cpu",
                         max_tokens=6, mesh=mesh)
    assert port.engine.pp_degree == 2
    want = script(JaxReplica(JCFG, max_len=128, max_tokens=6, mesh=jmesh))
    assert script(port) == want
