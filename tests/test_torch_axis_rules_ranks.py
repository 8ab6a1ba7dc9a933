"""Logical-axis tables other than the default on meshes over several
processes (gloo ranks on the CPU), against JAX's GSPMD model and step and
the port's single-controller one.

Each mesh spans a gloo world of spawned processes formed by the port's
Train backend. The tables are ``tests/test_torch_axis_rules.py``'s, and
``("seq", None)``: the MLP's units over fsdp and the batch over dp alone
on dp=2 x fsdp=2 (the latter's fsdp > 0 ranks compute no batch group and
only hold slices that the others read), the heads over tp x fsdp and the
embed dim over fsdp x tp on fsdp=2 x tp=2, one position a rank; the embed
dim over tp on fsdp=2 x tp=2 over two ranks (tp inside a rank, fsdp
across); no tensor parallelism on tp=2; the layer stack whole on pp=2 x
tp=2 and the sequence whole on sp=2 x tp=2, a stage's or a shard's two
tp positions a rank; and the batch over dp alone on pp=2 x fsdp=2, one
position a rank (stages across ranks, two microbatches, and a rank of
each stage that only holds slices).

Every rank starts from JAX's seed-0 state carried across with
``from_jax_state(..., mesh=)`` (its own slices only, each JAX's
addressable shard, bit for bit), runs ``make_eval_step``, ``loss_fn``,
``value_and_grad`` (its sampled gradients gathered across ranks) and
``forward``, and takes three steps of ``make_train_step`` on the whole
batch. JAX runs ``make_train_step`` on the same ``MeshSpec`` of the
conftest's CPU devices under the same table; the bounds are the
reference's (loss 1e-4, grad norm 1e-3 relative,
``tests/test_models.py:119-122``; forward, loss and gradients against
JAX's model at 1e-4), and 1e-5 against the port's single-controller run
on a mesh naming the CPU once per position. The state's specs equal
JAX's, and each rank's distinct state bytes the planner's per-rank
figure.

The MoE layer runs across two ranks with the experts whole
(``("expert", None)``: the embed dim over fsdp) on fsdp=2, and across
four with the embed dim over tp on fsdp=2 x tp=2 (w_gate and w_up
stored over experts and the embed dim, w_down over experts and MLP
units): y, the aux losses and the gradients summed over each slice's
holders within 1e-4 of JAX's ``moe_layer``.

The spawned ranks import this module, so it imports JAX and the JAX
package only inside fixtures.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import (PRESETS, MoEConfig, forward,
                                  from_jax_state, loss_fn, make_eval_step,
                                  make_optimizer, make_train_step,
                                  moe_logical_axes, moe_params_from_jax)
from ray_tpu_torch.models.moe import moe_layer_routed, moe_rows
from ray_tpu_torch.models.train_step import value_and_grad
from ray_tpu_torch.models.transformer import param_shapes
from ray_tpu_torch.parallel import (LogicalAxisRules, MeshSpec, build_mesh,
                                    gather_params, plan_train_memory,
                                    shard_params, tree_specs)
from ray_tpu_torch.parallel.sharding import gather_tensor, shard_slices
from test_torch_collective import spawn_ranks
from test_torch_train_ranks import (Adam, Schedule, _batches, _get,
                                    _np_tree, _paths, _tensors, _torch)
from test_torch_train_split_ranks import GRADS, _grad_sample

CFG = PRESETS["tiny"]
STEPS = 3
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# Each bounded wait of a world's ranks (their cases run one after another,
# while other test files may run beside them).
JOIN_S = 300
TABLES = {
    "mlp-fsdp": (("mlp", "fsdp"),),
    "batch-dp": (("batch", "dp"),),
    "heads-tp-fsdp": (("heads", ("tp", "fsdp")), ("embed", None)),
    "tp-unused": tuple((k, None) for k in ("heads", "kv_heads", "qkv",
                                           "mlp", "vocab")),
    "embed-tp": (("embed", "tp"),),
    "embed-fsdp-tp": (("embed", ("fsdp", "tp")),),
    "layer-none": (("layer", None),),
    "seq-none": (("seq", None),),
}
# name: (table, mesh, world, num_microbatches)
RUNS = {
    "mlp-fsdp-dp2xfsdp2": ("mlp-fsdp", dict(dp=2, fsdp=2), 4, None),
    "batch-dp-dp2xfsdp2": ("batch-dp", dict(dp=2, fsdp=2), 4, None),
    "heads-tp-fsdp-fsdp2xtp2": ("heads-tp-fsdp", dict(fsdp=2, tp=2), 4,
                                None),
    "embed-fsdp-tp-fsdp2xtp2": ("embed-fsdp-tp", dict(fsdp=2, tp=2), 4,
                                None),
    "batch-dp-pp2xfsdp2": ("batch-dp", dict(pp=2, fsdp=2), 4, 2),
    "embed-tp-fsdp2xtp2": ("embed-tp", dict(fsdp=2, tp=2), 2, None),
    "tp-unused-tp2": ("tp-unused", dict(tp=2), 2, None),
    "layer-none-pp2xtp2": ("layer-none", dict(pp=2, tp=2), 2, 2),
    "seq-none-sp2xtp2": ("seq-none", dict(sp=2, tp=2), 2, None),
}
NAMES = list(RUNS)
MOE_KW = dict(d_model=16, d_ff=32, num_experts=4)
MOE_B, MOE_S = 4, 8
AUX = ("moe_load_balance_loss", "moe_router_z_loss", "moe_fraction_dropped")
# name: (table, mesh, world)
MOE_RUNS = {"moe-expert-none-fsdp2": ((("expert", None),), dict(fsdp=2), 2),
            "moe-embed-tp-fsdp2xtp2": ((("embed", "tp"),),
                                       dict(fsdp=2, tp=2), 4)}
MOE_NAMES = list(MOE_RUNS)


def _rules(name):
    return LogicalAxisRules.default().with_overrides(*TABLES[RUNS[name][0]])


def _flat_specs(specs, prefix=""):
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_flat_specs(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tuple(specs)}


def _run(name, mesh, np_state, batches):
    """On one rank (or on one process): the carried state's slices
    checked, eval, loss_fn, value_and_grad and forward on it, then three
    steps; the gathered results."""
    _, _, _, mb = RUNS[name]
    rules = _rules(name)
    bundle = make_train_step(CFG, mesh, rules=rules,
                             optimizer=make_optimizer(warmup_steps=1),
                             num_microbatches=mb, device="cpu")
    specs = bundle.state_specs["params"]
    state = from_jax_state(np_state, CFG, "cpu", mesh=mesh, rules=rules)
    shapes = param_shapes(CFG)
    first = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    out = dict(specs=_flat_specs(specs), slices_exact=all(
        torch.equal(_get(state["params"][i], path),
                    torch.from_numpy(np.array(_get(
                        np_state["params"], path)))[shard_slices(
                            _get(specs, path), _get(shapes, path)[0], mesh,
                            mesh.coords()[i])])
        for i in mesh.local_positions() for path in _paths(shapes)))
    out["eval"] = float(make_eval_step(CFG, mesh, rules=rules, device="cpu")(
        state["params"], first))
    with torch.no_grad():
        out["loss_fn"] = float(loss_fn(state["params"], first, CFG, mesh,
                                       device="cpu", rules=rules,
                                       num_microbatches=mb))
        out["logits"] = forward(state["params"], first["tokens"][:, :-1],
                                CFG, mesh, device="cpu", rules=rules,
                                num_microbatches=mb).numpy()
    loss, grads = value_and_grad(state["params"], first, CFG, device="cpu",
                                 mesh=mesh, rules=rules,
                                 num_microbatches=mb)
    out["vg_loss"] = float(loss)
    out["grads"] = {path: _grad_sample(grads, path, specs, mesh)
                    for path in GRADS}
    del grads
    out["metrics"] = []
    for b in batches:
        state, m = bundle.step(state, {k: torch.as_tensor(v)
                                       for k, v in b.items()})
        out["metrics"].append((m["loss"], m["grad_norm"], m["step"]))
    opt = state["opt_state"]
    out["state"] = {k: _np_tree(gather_params(t, mesh, rules))
                    for k, t in (("params", state["params"]),
                                 ("mu", opt["mu"]), ("nu", opt["nu"]))}
    out["replicas_equal"] = all(
        np.array_equal(_get(tree[i], path).numpy(),
                       _get(out["state"][kind], path)[
                           shard_slices(_get(specs, path),
                                        _get(shapes, path)[0], mesh,
                                        mesh.coords()[i])])
        for kind, tree in (("params", state["params"]), ("mu", opt["mu"]),
                           ("nu", opt["nu"]))
        for i in mesh.local_positions() for path in _paths(shapes))
    out["held_bytes"] = sum({id(t): t.nbytes for i in mesh.local_positions()
                             for t in _tensors(state["params"][i])}.values())
    out["held_opt_bytes"] = sum(
        {id(t): t.nbytes for k in ("mu", "nu") for i in mesh.local_positions()
         for t in _tensors(opt[k][i])}.values())
    return out


def _moe_run(name, mesh, np_params, x):
    """The MoE layer on this rank (or on one process): its rows, y, aux,
    routing and its positions' parameter gradients."""
    over, _, _ = MOE_RUNS[name]
    rules = LogicalAxisRules.default().with_overrides(*over)
    cfg = MoEConfig(dtype=torch.float32, **MOE_KW)
    shards = shard_params(moe_params_from_jax(np_params, "cpu"), mesh, rules,
                          moe_logical_axes())
    leaves = {}
    sl = [None if t is None else {
        k: leaves.setdefault(id(v), v.detach().requires_grad_())
        for k, v in t.items()} for t in shards]
    y, aux, (idx, keep) = moe_layer_routed(sl, torch.from_numpy(x), cfg,
                                           mesh=mesh, rules=rules)
    objective = y.sum()
    if mesh.rank == 0:
        objective = objective + aux[AUX[0]] + aux[AUX[1]]
    objective.backward()
    return dict(rows=moe_rows(mesh, MOE_B * MOE_S) if mesh.world > 1
                else (0, MOE_B * MOE_S),
                y=y.detach().numpy(),
                aux={k: float(v.detach()) for k, v in aux.items()},
                idx=idx.numpy(), keep=keep.numpy(),
                grads=_distinct_grads(sl, mesh))


def _distinct_grads(sl, mesh):
    """Each local position's parameter gradients, a tensor that several
    positions share counted at the first of them (zeros at the others)."""
    seen, out = set(), {}
    for i in mesh.local_positions():
        out[i] = {}
        for k, v in sl[i].items():
            fresh = id(v) not in seen and v.grad is not None
            seen.add(id(v))
            out[i][k] = (v.grad if fresh else torch.zeros_like(v)).numpy()
    return out


def _ranks(rank, world, jobs, moe_jobs):
    """A world's cases: rank 0's results, the others' held bytes, slice
    and replica checks and MoE results."""
    out = {name: _run(name, build_mesh(MeshSpec(**RUNS[name][1])), np_state,
                      batches) for name, np_state, batches in jobs}
    if rank:
        out = {k: {f: v[f] for f in ("held_bytes", "held_opt_bytes",
                                     "replicas_equal", "slices_exact")}
               for k, v in out.items()}
    for name, np_params, x in moe_jobs:
        out[name] = _moe_run(name, build_mesh(MeshSpec(**MOE_RUNS[name][1])),
                             np_params, x)
    return out


@pytest.fixture(scope="module")
def start():
    """JAX's seed-0 state (plain picklable tuples), its unsharded loss,
    logits and gradients on the first batch, and per MoE case its params
    and x."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import PRESETS as JAX_PRESETS
    from ray_tpu.models import forward as jax_forward
    from ray_tpu.models import loss_fn as jax_loss_fn
    from ray_tpu.models import make_train_step as jax_make_train_step
    from ray_tpu.models.moe import MoEConfig as JaxMoEConfig
    from ray_tpu.models.moe import init_moe_params
    from ray_tpu.models.train_step import make_optimizer as jax_optimizer
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    jcfg = JAX_PRESETS["tiny"]
    one = jax_build_mesh(JaxMeshSpec(), devices=jax.devices()[:1])
    js = jax_make_train_step(jcfg, one, optimizer=jax_optimizer(
        warmup_steps=1)).init(jax.random.key(0))
    np_js = jax.tree.map(np.asarray, js)
    adam, sched = np_js["opt_state"][1][0], np_js["opt_state"][1][2]
    first = jax.tree.map(jnp.asarray, _batches()[0])
    loss, grads = jax.value_and_grad(jax_loss_fn)(js["params"], first, jcfg)
    moe = {}
    for name in MOE_RUNS:
        jcfg_moe = JaxMoEConfig(dtype=jnp.float32, **MOE_KW)
        moe[name] = (jax.tree.map(np.asarray, init_moe_params(
            jcfg_moe, jax.random.key(0))), np.array(jax.random.normal(
                jax.random.key(1), (MOE_B, MOE_S, jcfg_moe.d_model))))
    return dict(
        np_state={"params": np_js["params"],
                  "opt_state": (Adam(adam.count, adam.mu, adam.nu),
                                Schedule(sched.count)),
                  "step": np_js["step"]},
        unsharded=dict(loss=float(loss), grads=jax.tree.map(np.asarray,
                                                            grads),
                       logits=np.asarray(jax_forward(
                           js["params"], first["tokens"][:, :-1], jcfg))),
        moe=moe)


@pytest.fixture(scope="module")
def launched(start, tmp_path_factory):
    """Each world's ranks, started on a thread apiece so that they run
    while the JAX side computes: {world: future of every rank's
    results}."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {}
    for world in (2, 4):
        jobs = [(name, start["np_state"], _batches())
                for name, (_, _, w, _) in RUNS.items() if w == world]
        moe_jobs = [(name, *start["moe"][name])
                    for name, (_, _, w) in MOE_RUNS.items() if w == world]
        futures[world] = pool.submit(
            spawn_ranks, _ranks, world,
            tmp_path_factory.mktemp(f"rules{world}"), jobs, moe_jobs,
            timeout=JOIN_S)
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_side(start, launched):
    """Per case JAX's GSPMD step under the table: three steps' metrics
    (step 1's loss is its loss on the first batch), the final state and
    the state's specs; per MoE case y, aux and gradients of its layer on
    its params placed by the table."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import PRESETS as JAX_PRESETS
    from ray_tpu.models import make_train_step as jax_make_train_step
    from ray_tpu.models.moe import MoEConfig as JaxMoEConfig
    from ray_tpu.models.moe import moe_layer
    from ray_tpu.models.moe import moe_logical_axes as jax_moe_axes
    from ray_tpu.models.train_step import make_optimizer as jax_optimizer
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    from ray_tpu.parallel.sharding import LogicalAxisRules as JaxRules
    from ray_tpu.parallel.sharding import tree_shardings
    jcfg = JAX_PRESETS["tiny"]
    out = {}
    for name, (table, spec, _, mb) in RUNS.items():
        rules = JaxRules.default().with_overrides(*TABLES[table])
        n = MeshSpec(**spec).n_devices
        jmesh = jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:n])
        bundle = jax_make_train_step(jcfg, jmesh, rules=rules,
                                     optimizer=jax_optimizer(warmup_steps=1),
                                     num_microbatches=mb)
        js = bundle.init(jax.random.key(0))
        metrics = []
        for b in _batches():
            js, m = bundle.step(js, jax.tree.map(jnp.asarray, b))
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        out[name] = dict(metrics=metrics, state=jax.tree.map(np.asarray, js),
                         specs={k: tuple(s.spec) for k, s in _flat_leaves(
                             bundle.state_shardings["params"])})
    for name, (over, spec, _) in MOE_RUNS.items():
        jcfg_moe = JaxMoEConfig(dtype=jnp.float32, **MOE_KW)
        np_params, x = start["moe"][name]
        jmesh = jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[
            :MeshSpec(**spec).n_devices])
        placed = jax.device_put(
            jax.tree.map(jnp.asarray, np_params),
            tree_shardings(jax_moe_axes(), jmesh,
                           JaxRules.default().with_overrides(*over)))

        def objective(p, jcfg_moe=jcfg_moe, x=x):
            y, aux = moe_layer(p, x, jcfg_moe)
            return y.sum() + aux[AUX[0]] + aux[AUX[1]], (y, aux)
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            objective, has_aux=True))(placed)
        out[name] = dict(y=np.asarray(y),
                         aux={k: float(v) for k, v in aux.items()},
                         grads=jax.tree.map(np.asarray, grads))
    return out


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.fixture(scope="module")
def single(start):
    """The port's single-controller runs, from the same state."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {name: _run(name, build_mesh(MeshSpec(**spec), devices=[
            "cpu"] * MeshSpec(**spec).n_devices), start["np_state"],
            _batches()) for name, (_, spec, _, _) in RUNS.items()}
        for name, (_, spec, _) in MOE_RUNS.items():
            out[name] = _moe_run(name, build_mesh(MeshSpec(**spec), devices=[
                "cpu"] * MeshSpec(**spec).n_devices), *start["moe"][name])
        return out
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(launched):
    """{world: every rank's results}."""
    return {world: f.result() for world, f in launched.items()}


def _rank0(ranks, name):
    return ranks[RUNS[name][2]][0][name]


@pytest.mark.parametrize("name", NAMES)
def test_steps_match_jax(name, start, jax_side, ranks):
    """Eval, loss_fn, forward and value_and_grad against JAX's model and
    its GSPMD loss, and three steps against JAX's GSPMD step under the
    same table."""
    from test_torch_train_step import _assert_params_close
    got, want, ref = _rank0(ranks, name), jax_side[name], start["unsharded"]
    for key in ("eval", "loss_fn", "vg_loss"):
        np.testing.assert_allclose(got[key], want["metrics"][0][0],
                                   rtol=1e-4)
        np.testing.assert_allclose(got[key], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["logits"], ref["logits"], **TOL)
    for path in GRADS:
        want_g = (_get(ref["grads"], ("layers",) + path[2:])[path[1]]
                  if path[0] == "layers" else _get(ref["grads"], path))
        np.testing.assert_allclose(got["grads"][path], want_g,
                                   err_msg=str(path), **GRAD_TOL)
    for (loss, gnorm, step), (jl, jg, js) in zip(got["metrics"],
                                                 want["metrics"]):
        np.testing.assert_allclose(loss, jl, rtol=1e-4)
        np.testing.assert_allclose(gnorm, jg, rtol=1e-3)
        assert step == js
    _assert_params_close(_torch(got["state"]["params"]),
                         want["state"]["params"], lr_steps=STEPS - 1)


@pytest.mark.parametrize("name", NAMES)
def test_steps_match_the_single_controller(name, single, ranks):
    from test_torch_train_step import _assert_params_close
    got, want = _rank0(ranks, name), single[name]
    for key in ("eval", "loss_fn", "vg_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                               atol=1e-5)
    for path in GRADS:
        np.testing.assert_allclose(got["grads"][path], want["grads"][path],
                                   rtol=1e-5, atol=1e-7, err_msg=str(path))
    for (loss, gnorm, step), (wl, wg, ws) in zip(got["metrics"],
                                                 want["metrics"]):
        np.testing.assert_allclose(loss, wl, rtol=1e-5)
        np.testing.assert_allclose(gnorm, wg, rtol=1e-5)
        assert step == ws
    _assert_params_close(_torch(got["state"]["params"]),
                         want["state"]["params"], lr_steps=STEPS - 1)
    for kind in ("mu", "nu"):
        for path in _paths(want["state"][kind]):
            np.testing.assert_allclose(_get(got["state"][kind], path),
                                       _get(want["state"][kind], path),
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_specs_slices_and_planner_bytes_are_exact(name, jax_side, ranks):
    """The state's specs are JAX's; every rank's carried slices are JAX's
    addressable shards, bit for bit; its replicas stay bit-equal through
    the steps; its distinct params and moments bytes are the planner's
    per-rank figures."""
    _, spec, world, mb = RUNS[name]
    assert _rank0(ranks, name)["specs"] == jax_side[name]["specs"]
    got = [r[name] for r in ranks[world]]
    assert [g["slices_exact"] for g in got] == [True] * world
    assert [g["replicas_equal"] for g in got] == [True] * world
    plan = plan_train_memory(CFG, MeshSpec(**spec), global_batch=4,
                             seq_len=16, rules=_rules(name),
                             num_microbatches=mb, hbm_gib=1, world=world)
    assert [g["held_bytes"] for g in got] == [plan.rank_params_bytes] * world
    assert [g["held_opt_bytes"] for g in got] == \
        [plan.rank_opt_bytes] * world


def _moe_gathered(per, name):
    """Each MoE parameter's gradient, whole: per slice, the sum over the
    distinct tensors that hold it (a read's gradient lands on one
    holder)."""
    over, spec, _ = MOE_RUNS[name]
    n = MeshSpec(**spec).n_devices
    mesh = build_mesh(MeshSpec(**spec), devices=["cpu"] * n)
    specs = tree_specs(moe_logical_axes(), mesh,
                       LogicalAxisRules.default().with_overrides(*over))
    out = {}
    for k, spec_k in specs.items():
        shape = gather_tensor([torch.from_numpy(per[i][k]) for i in range(n)],
                              spec_k, mesh).shape
        full = np.zeros(shape, np.float32)
        for i, c in enumerate(mesh.coords()):
            full[shard_slices(spec_k, shape, mesh, c)] += per[i][k]
        out[k] = full
    return out


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_layer_across_ranks_matches_jax(name, jax_side, single, ranks):
    """Each rank's run of y, its aux losses and the gradients summed over
    each slice's holders against JAX's moe_layer and the single
    controller's; the routing equal to the single controller's."""
    want = jax_side[name]
    got = [r[name] for r in ranks[MOE_RUNS[name][2]]]
    y = want["y"].reshape(MOE_B * MOE_S, -1)
    per = {}
    for g in got:
        a, b = g["rows"]
        np.testing.assert_allclose(g["y"], y[a:b], **TOL)
        for k in AUX:
            np.testing.assert_allclose(g["aux"][k], want["aux"][k], **TOL)
        np.testing.assert_array_equal(g["idx"], single[name]["idx"])
        np.testing.assert_array_equal(g["keep"], single[name]["keep"])
        per.update(g["grads"])
    mine, one = _moe_gathered(per, name), _moe_gathered(
        single[name]["grads"], name)
    for k, w in want["grads"].items():
        np.testing.assert_allclose(mine[k], w, err_msg=k, **TOL)
        np.testing.assert_allclose(mine[k], one[k], err_msg=k, **TOL)
