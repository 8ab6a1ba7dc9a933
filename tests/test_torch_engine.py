"""Parity of ray_tpu_torch's LLM engine with the JAX engine on the CPU.

The JAX engine's params are carried across, then greedy tokens must be
identical for the prompts and settings of tests/test_llm.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSamplingParams
from ray_tpu.llm.engine import _prefill_fn as jax_prefill_fn
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.llm.engine import _prefill_fn
from ray_tpu_torch.models import PRESETS, from_jax_params
from ray_tpu_torch.parallel import LogicalAxisRules, MeshSpec, build_mesh

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them, and these
    small shapes gain nothing from more threads."""
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


def _both(jeng, teng, prompts, **sp):
    want = jeng.generate(prompts, JaxSamplingParams(**sp))
    got = teng.generate(prompts, SamplingParams(**sp))
    return want, got


def test_one_prompt_greedy_matches_jax():
    jeng, teng = _pair(max_batch=2, max_len=64, seed=0)
    want, got = _both(jeng, teng, [[3, 17, 42, 7, 99, 5, 23]], max_tokens=8)
    assert got == want
    assert len(got[0]) == 8


def test_three_prompts_through_two_slots_match_jax():
    jeng, teng = _pair(max_batch=2, max_len=64, seed=1)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11], [12, 13]]
    want, got = _both(jeng, teng, prompts, max_tokens=5)
    assert got == want
    assert all(len(o) == 5 for o in got)
    assert teng.kv_pages_free() == teng.kv_pages_total
    assert teng.active_requests == 0 and teng.queue_depth == 0


def test_eos_stop_matches_jax():
    jeng, teng = _pair(max_batch=1, max_len=64, seed=0)
    prompt = [3, 17, 42]
    free_want, free_got = _both(jeng, teng, [prompt], max_tokens=10)
    assert free_got == free_want
    eos = free_got[0][3]
    jeng2, teng2 = _pair(max_batch=1, max_len=64, seed=0)
    want, got = _both(jeng2, teng2, [prompt], max_tokens=10, eos_id=eos)
    assert got == want == [free_got[0][:4]]


@pytest.mark.parametrize("length,bucket", [(7, 8), (13, 16), (32, 32)])
def test_prefill_fn_matches_jax(length, bucket):
    jeng, teng = _pair(max_batch=1, max_len=64, seed=2)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :length] = np.random.default_rng(length).integers(
        1, CFG.vocab_size, length)
    want = jax_prefill_fn(jeng.params, jnp.asarray(toks), length, JCFG)
    logits, ks, vs = _prefill_fn([teng.params], torch.from_numpy(toks).long(),
                                 length, CFG)
    got = (logits, ks[0], vs[0])
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_tick_events_and_page_accounting():
    _, teng = _pair(max_batch=2, max_len=64, seed=0, page_size=8)
    ids = [teng.add_request([5, 6, 7], SamplingParams(max_tokens=3)),
           teng.add_request(list(range(1, 12)), SamplingParams(max_tokens=3))]
    assert teng.queue_depth == 2
    teng.step()
    events = teng.take_tick_events()
    # admission first tokens, then one decode token each
    assert [rid for rid, _, _ in events] == ids + ids
    assert teng.active_requests == 2
    # ceil((3 + 3 + 1) / 8) + ceil((11 + 3 + 1) / 8) pages held
    assert teng.kv_pages_total - teng.kv_pages_free() == 1 + 2
    while teng.has_unfinished():
        teng.step()
    assert teng.kv_pages_free() == teng.kv_pages_total


def test_temperature_sampling_runs_in_range():
    _, teng = _pair(max_batch=2, max_len=64, seed=0)
    outs = teng.generate([[1, 2, 3], [4, 5]],
                         SamplingParams(max_tokens=6, temperature=0.8))
    assert all(len(o) == 6 for o in outs)
    assert all(0 <= t < CFG.vocab_size for o in outs for t in o)


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(PRESETS["tiny"])


def test_unported_engine_options_are_absent():
    """sp_degree, sp_strategy, every serving mesh (sp, tp, pp, dp, fsdp
    and any of them together) and any rule table are ported
    (tests/test_torch_sp_prefill.py, tests/test_torch_tp_engine.py,
    tests/test_torch_mesh_engine.py, tests/test_torch_axis_rules.py). The
    reference's default table, which splits the vocabulary over tp, serves
    the JAX engine's greedy tokens on tp=2, each position holding its
    vocabulary slice."""
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    from ray_tpu.parallel.sharding import LogicalAxisRules as JaxRules
    tp2 = build_mesh(MeshSpec(tp=2), devices=["cpu"] * 2)
    jtp2 = jax_build_mesh(JaxMeshSpec(tp=2), devices=jax.devices()[:2])
    kw = dict(max_batch=2, max_len=64, seed=0)
    jeng = JaxEngine(JCFG, mesh=jtp2, rules=JaxRules.default(), **kw)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG,
                             "cpu")
    teng = LLMEngine(CFG, params, device="cpu", mesh=tp2,
                     rules=LogicalAxisRules.default(), **kw)
    assert [s["embed"].shape[0] for s in teng._shards] == \
        [CFG.vocab_size // 2] * 2
    want, got = _both(jeng, teng, [[3, 17, 42, 7, 99, 5, 23], [4, 5]],
                      max_tokens=8)
    assert got == want
    for spec in (dict(sp=2, tp=2), dict(dp=2), dict(fsdp=2, sp=2),
                 dict(pp=2), dict(pp=2, sp=2)):
        mesh = build_mesh(MeshSpec(**spec),
                          devices=["cpu"] * MeshSpec(**spec).n_devices)
        eng = LLMEngine(CFG, device="cpu", mesh=mesh, max_len=64)
        assert (eng.tp_degree, eng.pp_degree, eng.sp_degree) == (
            spec.get("tp", 1), spec.get("pp", 1), spec.get("sp", 1))
    eng = LLMEngine(CFG, device="cpu", max_len=64, sp_degree=2,
                    sp_strategy="ulysses",
                    mesh=build_mesh(MeshSpec(sp=2), devices=["cpu"] * 2))
    assert (eng.sp_degree, eng.sp_strategy) == (2, "ulysses")


def test_request_validation():
    _, teng = _pair(max_batch=1, max_len=32, seed=0, page_size=8,
                    kv_pages=2)
    with pytest.raises(ValueError, match="max_len"):
        teng.add_request(list(range(32)))
    with pytest.raises(ValueError, match="KV pages"):
        teng.add_request([1, 2], SamplingParams(max_tokens=20))


def test_port_imports_neither_jax_nor_ray_tpu():
    """The port and chip_smoke.py import no jax, no optax and no ray_tpu
    module, and neither cloudpickle nor ml_dtypes, which the card's machine
    lacks. A subprocess: this test process already holds jax (conftest)."""
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.llm.engine\n"
        "import ray_tpu_torch._config, ray_tpu_torch.exceptions\n"
        "import ray_tpu_torch._private.flight_recorder\n"
        "import ray_tpu_torch.llm.sequence_parallel\n"
        "import ray_tpu_torch.parallel.mesh, ray_tpu_torch.parallel.sharding\n"
        "import ray_tpu_torch.ops.ring_attention\n"
        "import ray_tpu_torch.models.transformer, ray_tpu_torch.ops._build\n"
        "import ray_tpu_torch.models.train_step, ray_tpu_torch.models.moe\n"
        "import ray_tpu_torch.parallel.pipeline\n"
        "import ray_tpu_torch.parallel.planner\n"
        "import ray_tpu_torch.llm.serving, ray_tpu_torch.llm.openai_api\n"
        "import ray_tpu_torch.llm.batch, ray_tpu_torch._private.deadlines\n"
        "import ray_tpu_torch.collective.collective\n"
        "import ray_tpu_torch.tpu.accelerator, ray_tpu_torch.train.backend\n"
        "import ray_tpu_torch.train.examples.transformer_example\n"
        "import ray_tpu_torch._private.device_plane\n"
        "import ray_tpu_torch._private.serialization\n"
        "import ray_tpu_torch.experimental\n"
        "import ray_tpu_torch.util.perf\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'optax')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'optax.'))\n"
        "             or m == 'ray_tpu' or m.startswith('ray_tpu.')\n"
        "             or m.split('.')[0] in ('cloudpickle', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
