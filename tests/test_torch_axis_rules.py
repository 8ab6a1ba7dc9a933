"""Parity of ray_tpu_torch's sharded model, train step, engine and MoE
layer with the JAX package's under logical-axis tables other than the
default and the Megatron one, on the CPU.

JAX places its params with ``tree_shardings`` under each table on meshes
of the conftest's 8 CPU devices and lets GSPMD compute. The port stores
each position's slices as the table says, on meshes that name the CPU n
times, and computes in its own layout (Megatron over tp, the layer stack
over pp, the vocabulary over tp where the table splits it there),
gathering and slicing the stored slices at use
(``models.transformer._ParamPlan``). ``PRESETS["tiny"]`` is f32: forward,
loss, gradients, the engine's logits and the MoE layer at 1e-4, the steps
at the reference's sharded-vs-single tolerances
(``tests/test_models.py:119-122``), specs, slices and planner bytes
exactly.

Under ``("embed", ("fsdp", "tp"))`` on dp=2 x fsdp=2 x tp=2 the
reference's sharded forward departs from its own unsharded logits
(ROADMAP Queue 3); the port follows the unsharded model there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.llm.engine import _prefill_fn as jax_prefill_fn
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu.models import forward as jax_forward
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models import loss_fn as jax_loss_fn
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models.moe import MoEConfig as JaxMoEConfig
from ray_tpu.models.moe import init_moe_params as jax_init_moe_params
from ray_tpu.models.moe import moe_layer as jax_moe_layer
from ray_tpu.models.moe import moe_logical_axes as jax_moe_logical_axes
from ray_tpu.models.train_step import make_optimizer as jax_make_optimizer
from ray_tpu.models.transformer import \
    param_logical_axes as jax_param_logical_axes
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu.parallel.planner import plan_train_memory as jax_plan
from ray_tpu.parallel.sharding import LogicalAxisRules as JaxRules
from ray_tpu.parallel.sharding import tree_shardings as jax_tree_shardings
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.models import (MoEConfig, PRESETS, forward,
                                  from_jax_params, from_jax_state, loss_fn,
                                  make_optimizer, make_train_step, moe_layer,
                                  moe_logical_axes, moe_params_from_jax)
from ray_tpu_torch.models.train_step import value_and_grad
from ray_tpu_torch.models.transformer import PositionView
from ray_tpu_torch.parallel import (LogicalAxisRules, MeshSpec, build_mesh,
                                    gather_params, plan_train_memory,
                                    shard_params)
from test_torch_collective import spawn_ranks
from test_torch_train_step import _check_state

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 3
TABLES = {
    "mlp-fsdp": (("mlp", "fsdp"),),
    "batch-dp": (("batch", "dp"),),
    "heads-tp-fsdp": (("heads", ("tp", "fsdp")), ("embed", None)),
    "tp-unused": tuple((k, None) for k in ("heads", "kv_heads", "qkv",
                                           "mlp", "vocab")),
    "embed-tp": (("embed", "tp"),),
    "embed-fsdp-tp": (("embed", ("fsdp", "tp")),),
    "layer-none": (("layer", None),),
}
MESHES = {"2x2x2": dict(dp=2, fsdp=2, tp=2), "fsdp2xtp2": dict(fsdp=2, tp=2),
          "pp2xtp2": dict(pp=2, tp=2)}
CASES = ([(t, m) for t in TABLES if t != "layer-none"
          for m in ("2x2x2", "fsdp2xtp2")] + [("layer-none", "pp2xtp2")])
# The reference's sharded forward is not its unsharded model here.
FAULT = ("embed-fsdp-tp", "2x2x2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; these small
    shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rules(table):
    over = TABLES[table]
    return (JaxRules.default().with_overrides(*over),
            LogicalAxisRules.default().with_overrides(*over))


def _meshes(spec):
    n = MeshSpec(**spec).n_devices
    return (jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:n]),
            build_mesh(MeshSpec(**spec), devices=[CPU] * n))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _stacked(tree):
    """A per-position tree whose "layers" is a per-layer list, stacked
    back into the (L, ...) layout."""
    layers = tree["layers"]
    if not isinstance(layers, list):
        return tree

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return torch.stack(nodes)
    return dict(tree, layers=stack(*layers))


def _optimizer(jax_side: bool):
    return (jax_make_optimizer if jax_side else make_optimizer)(
        warmup_steps=1)


@pytest.fixture(scope="module")
def ref():
    """JAX's unsharded model on one batch: params, logits, loss and
    gradients, and three steps of its make_train_step on one device from
    its seed-0 state (its state before and after, its metrics)."""
    jp = jax_init_params(JCFG, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(
        1, CFG.vocab_size, (8, 17)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    loss, grads = jax.value_and_grad(jax_loss_fn)(jp, batch, JCFG)
    logits = jax_forward(jp, batch["tokens"], JCFG)
    one = jax_build_mesh(JaxMeshSpec(), devices=jax.devices()[:1])
    bundle = jax_make_train_step(JCFG, one, optimizer=_optimizer(True))
    js = bundle.init(jax.random.key(0))
    start, metrics = _np(js), []
    for _ in range(STEPS):
        js, m = bundle.step(js, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(params=jp, tokens=tokens, loss=float(loss),
                grads=_np(grads), logits=np.asarray(logits), start=start,
                end=_np(js), metrics=metrics)


@pytest.mark.parametrize("table,mesh_name", CASES)
def test_model_and_step_follow_the_table(ref, table, mesh_name):
    """Under the table: the state's specs are JAX's and each position's
    slices its addressable shards, bit for bit; forward and loss_fn
    against JAX's sharded run (its unsharded model where it departs from
    it) and unsharded model; value_and_grad's gathered gradients against
    JAX's; the planner's state bytes against JAX's and each position's
    own; three steps from ``from_jax_state(mesh=)`` against JAX's."""
    spec = MESHES[mesh_name]
    jmesh, mesh = _meshes(spec)
    jrules, rules = _rules(table)
    params = from_jax_params(_np(ref["params"]), CFG, "cpu")
    tokens = torch.from_numpy(ref["tokens"])
    jshd = jax_tree_shardings(jax_param_logical_axes(JCFG), jmesh, jrules)
    placed = jax.device_put(ref["params"], jshd)

    tb = make_train_step(CFG, mesh, optimizer=_optimizer(False),
                         rules=rules, device="cpu")
    want_specs = {k: tuple(s.spec) for k, s in _leaves(jshd)}
    assert {k: tuple(v) for k, v in _leaves(tb.state_specs["params"])} \
        == want_specs
    shards = shard_params(params, mesh, rules)
    mine = [dict(_leaves(s)) for s in shards]
    for name, arr in _leaves(placed):
        by_dev = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for i, dev in enumerate(jmesh.devices.flat):
            np.testing.assert_array_equal(mine[i][name].numpy(),
                                          by_dev[dev])

    with torch.no_grad():
        logits = forward(shards, tokens, CFG, mesh, device="cpu",
                         rules=rules).numpy()
        loss = float(loss_fn(shards, {"tokens": tokens}, CFG, mesh,
                             device="cpu", rules=rules))
    np.testing.assert_allclose(logits, ref["logits"], **TOL)
    np.testing.assert_allclose(loss, ref["loss"], **TOL)
    if (table, mesh_name) != FAULT:
        jlogits = jax.jit(lambda p, t: jax_forward(p, t, JCFG, jmesh,
                                                   jrules))(
            placed, jnp.asarray(ref["tokens"]))
        np.testing.assert_allclose(logits, np.asarray(jlogits), **TOL)

    vloss, grads = value_and_grad(shards, {"tokens": tokens}, CFG,
                                  device="cpu", mesh=mesh, rules=rules)
    np.testing.assert_allclose(float(vloss), ref["loss"], **TOL)
    full = gather_params([_stacked(g) for g in grads], mesh, rules)
    want = dict(_leaves(ref["grads"]))
    for name, g in _leaves(full):
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)

    plan = plan_train_memory(CFG, MeshSpec(**spec), global_batch=8,
                             seq_len=16, rules=rules, hbm_gib=80.0)
    jplan = jax_plan(JCFG, JaxMeshSpec(**spec), global_batch=8, seq_len=16,
                     rules=jrules, hbm_gib=80.0)
    assert (plan.params_bytes, plan.grads_bytes, plan.opt_bytes) == \
        (jplan.params_bytes, jplan.grads_bytes, jplan.opt_bytes)

    ts = from_jax_state(ref["start"], CFG, "cpu", mesh=mesh, rules=rules)
    for i in range(len(shards)):
        own = sum(t.nbytes for _, t in _leaves(ts["params"][i]))
        moments = sum(t.nbytes for k in ("mu", "nu")
                      for _, t in _leaves(ts["opt_state"][k][i]))
        assert (own, moments) == (plan.params_bytes, plan.opt_bytes)
    batch = {"tokens": tokens}
    for i in range(STEPS):
        ts, m = tb.step(ts, batch)
        np.testing.assert_allclose(m["loss"], ref["metrics"][i][0],
                                   rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"], ref["metrics"][i][1],
                                   rtol=1e-3)
    gathered = {"params": gather_params(ts["params"], mesh, rules),
                "opt_state": {**ts["opt_state"], **{
                    k: gather_params(ts["opt_state"][k], mesh, rules)
                    for k in ("mu", "nu")}},
                "step": ts["step"]}
    _check_state(gathered, ref["end"], lr_steps=STEPS - 1)


def test_batch_over_dp_takes_the_batches_dp_divides(ref):
    """Under ``("batch", "dp")`` on dp=2 x fsdp=2 x tp=2 the batch splits
    over dp alone: two rows, which the default table's four batch groups
    refuse, give JAX's loss under the same table."""
    jmesh, mesh = _meshes(MESHES["2x2x2"])
    jrules, rules = _rules("batch-dp")
    assert mesh.batch_groups(rules) == [(0, 0), (1, 0)]
    tokens = ref["tokens"][:2]
    placed = jax.device_put(ref["params"], jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh, jrules))
    want = float(jax.jit(lambda p, t: jax_loss_fn(
        p, {"tokens": t}, JCFG, jmesh, jrules))(placed, jnp.asarray(tokens)))
    params = from_jax_params(_np(ref["params"]), CFG, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        got = float(loss_fn(params, batch, CFG, mesh, device="cpu",
                            rules=rules))
        with pytest.raises(ValueError, match="dp x fsdp=4"):
            loss_fn(params, batch, CFG, mesh, device="cpu")
    np.testing.assert_allclose(got, want, **TOL)


def test_the_reference_diverges_where_the_port_does_not(ref):
    """ROADMAP Queue 3: under ``("embed", ("fsdp", "tp"))`` on dp=2 x
    fsdp=2 x tp=2 the reference's sharded forward departs from its own
    unsharded logits by far more than f32 rounding (4.707 at most when the
    fault was recorded), while the port's stays within 1e-4 of them."""
    jmesh, mesh = _meshes(MESHES["2x2x2"])
    jrules, rules = _rules("embed-fsdp-tp")
    placed = jax.device_put(ref["params"], jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh, jrules))
    jlogits = np.asarray(jax.jit(lambda p, t: jax_forward(
        p, t, JCFG, jmesh, jrules))(placed, jnp.asarray(ref["tokens"])))
    assert np.abs(jlogits - ref["logits"]).max() > 1.0
    params = from_jax_params(_np(ref["params"]), CFG, "cpu")
    with torch.no_grad():
        logits = forward(params, torch.from_numpy(ref["tokens"]), CFG, mesh,
                         device="cpu", rules=rules).numpy()
    np.testing.assert_allclose(logits, ref["logits"], **TOL)


@pytest.mark.parametrize("spec", [dict(tp=2), dict(fsdp=2, tp=2)])
def test_engine_serves_the_default_table(spec):
    """LLMEngine(mesh=, rules=LogicalAxisRules.default()) against JAX's
    engine under the same table: greedy tokens through two slots, and a
    prefill's last logits within 1e-4. Each tp position holds its
    vocabulary slice (the embedding and logits vocabulary-parallel); on
    fsdp=2 the one replica's positions hold embed-dim slices and gather
    each layer at use (``PositionView``)."""
    jmesh, mesh = _meshes(spec)
    kw = dict(max_batch=2, max_len=64, seed=0, page_size=8)
    jeng = JaxEngine(JCFG, mesh=jmesh, rules=JaxRules.default(), **kw)
    params = from_jax_params(_np(jeng.params), CFG, "cpu")
    eng = LLMEngine(CFG, params, device="cpu", mesh=mesh,
                    rules=LogicalAxisRules.default(), **kw)
    assert eng.params is None and len(eng._reps) == 1
    assert len(eng._shards) == 2
    assert all(isinstance(s, PositionView) == ("fsdp" in spec)
               for s in eng._shards)
    assert [s["embed"].shape for s in eng._shards] == \
        [(CFG.vocab_size // 2, CFG.hidden_size)] * 2
    prompts = [[3, 17, 42, 7, 99, 5, 23], list(range(1, 30))]
    want = jeng.generate(prompts, JaxSP(max_tokens=8))
    assert eng.generate(prompts, SamplingParams(max_tokens=8)) == want
    toks = np.zeros((1, 32), np.int64)
    toks[0, :29] = prompts[1]
    jl = jax_prefill_fn(jeng.params, jnp.asarray(toks, jnp.int32), 29,
                        JCFG)[0]
    tl = eng._run_prefill(prompts[1])[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_engine_paged_requests_under_the_default_table():
    """The paged path under ``LogicalAxisRules.default()`` on fsdp=2 x
    tp=2 (its streamed attention and vocabulary-parallel embedding and
    logits through ``PositionView``): prefill_paged of a 100-token
    context into four parts and decode_paged through a window of 2, the
    tokens and the first token equal to JAX's engine under the same
    table, the parts within 1e-4."""
    jmesh, mesh = _meshes(dict(fsdp=2, tp=2))
    paged = dict(max_batch=1, max_len=64, page_size=16, kv_pages=4,
                 seed=0)
    jpre = JaxEngine(JCFG, mesh=jmesh, rules=JaxRules.default(), **paged)
    params = from_jax_params(_np(jpre.params), CFG, "cpu")
    jdec = JaxEngine(JCFG, jpre.params, mesh=jmesh, rules=JaxRules.default(),
                     kv_gather_window=2, **paged)
    pre, dec = (LLMEngine(CFG, params, device="cpu", mesh=mesh,
                          rules=LogicalAxisRules.default(), **kw)
                for kw in (paged, dict(paged, kv_gather_window=2)))
    prompt = np.random.default_rng(5).integers(1, CFG.vocab_size,
                                               100).tolist()
    jh = jpre.prefill_paged(prompt, JaxSP(max_tokens=6), span=32)
    h = pre.prefill_paged(prompt, SamplingParams(max_tokens=6), span=32)
    assert (h["len"], h["first"]) == (jh["len"], jh["first"])
    for g, w in zip(h["parts"], jh["parts"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(np.asarray(g["handle"][name]),
                                       np.asarray(w["handle"][name]), **TOL)
    assert dec.decode_paged(h, SamplingParams(max_tokens=6)) == \
        jdec.decode_paged(jh, JaxSP(max_tokens=6))


def test_moe_layer_under_embed_over_tp():
    """moe_layer(mesh=, rules=) under ``("embed", "tp")`` on fsdp=2 x
    sp=2 x tp=2: w_gate and w_up stored over experts and the embed dim,
    w_down over experts and MLP units, the router over its embed dim; y
    and the aux losses against JAX's layer on its params placed by the
    same table."""
    kw = dict(d_model=16, d_ff=32, num_experts=4)
    jcfg = JaxMoEConfig(dtype=jnp.float32, **kw)
    cfg = MoEConfig(dtype=torch.float32, **kw)
    jp = jax_init_moe_params(jcfg, jax.random.key(0))
    x = np.array(jax.random.normal(jax.random.key(1), (4, 8, 16)))
    spec = dict(fsdp=2, sp=2, tp=2)
    jmesh, mesh = _meshes(spec)
    over = (("embed", "tp"),)
    jrules = JaxRules.default().with_overrides(*over)
    rules = LogicalAxisRules.default().with_overrides(*over)
    placed = jax.device_put(jp, jax_tree_shardings(jax_moe_logical_axes(),
                                                   jmesh, jrules))
    jy, jaux = jax.jit(lambda p, x: jax_moe_layer(p, x, jcfg))(placed, x)
    params = moe_params_from_jax(_np(jp), "cpu")
    shards = shard_params(params, mesh, rules, moe_logical_axes())
    assert tuple(shards[0]["w_gate"].shape) == (1, 8, 32)
    assert tuple(shards[0]["w_down"].shape) == (1, 16, 16)
    with torch.no_grad():
        y, aux = moe_layer(shards, torch.from_numpy(x), cfg, mesh, rules)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), **TOL)


def _other_table_across_ranks(rank, world, one_process=False):
    """On fsdp=2 over the world's two ranks (or in one process, naming the
    CPU twice), under tables other than the default: one step of the
    train step under ``("mlp", "fsdp")`` from the seeded params, loss_fn
    on them, and the MoE layer under ``("expert", None)`` (the experts
    whole, so the embed dim goes over fsdp): the metrics, the loss, y of
    this rank's run of the tokens and the aux losses."""
    from ray_tpu_torch.models import init_moe_params, init_params
    from ray_tpu_torch.models.moe import moe_rows
    mesh = build_mesh(MeshSpec(fsdp=2),
                      devices=["cpu"] * 2 if one_process else None)
    other = LogicalAxisRules.default().with_overrides(("mlp", "fsdp"))
    moe_other = LogicalAxisRules.default().with_overrides(("expert", None))
    cfg = MoEConfig(d_model=8, d_ff=16, num_experts=4, dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        1, CFG.vocab_size, (2, 5)))}
    bundle = make_train_step(CFG, mesh, rules=other, device="cpu",
                             optimizer=_optimizer(False))
    _, metrics = bundle.step(bundle.init(), batch)
    with torch.no_grad():
        loss = loss_fn(init_params(CFG, device="cpu"), batch, CFG, mesh,
                       device="cpu", rules=other)
        x = torch.from_numpy(np.random.default_rng(4).normal(
            size=(1, 4, 8)).astype(np.float32))
        y, aux = moe_layer(init_moe_params(cfg, device="cpu"), x, cfg, mesh,
                           moe_other)
    return dict(metrics=(metrics["loss"], metrics["grad_norm"]),
                loss=float(loss), y=y.reshape(-1, 8).numpy(),
                rows=(0, 4) if one_process else moe_rows(mesh, 4),
                aux={k: float(v) for k, v in aux.items()})


def test_another_table_across_processes_matches_one_process(tmp_path):
    """Across processes a table other than the default and
    megatron_rules() runs (ROADMAP item 17b): on every rank the train
    step, the loss and the MoE layer under it agree with the same calls
    in one process."""
    one = _other_table_across_ranks(0, 1, one_process=True)
    for out in spawn_ranks(_other_table_across_ranks, 2, tmp_path):
        np.testing.assert_allclose(out["metrics"], one["metrics"],
                                   rtol=1e-5)
        np.testing.assert_allclose(out["loss"], one["loss"], rtol=1e-5)
        a, b = out["rows"]
        np.testing.assert_allclose(out["y"], one["y"][a:b], **TOL)
        for k, v in one["aux"].items():
            np.testing.assert_allclose(out["aux"][k], v, **TOL)
