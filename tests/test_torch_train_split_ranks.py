"""The per-rank train step with a tp, sp or pp group split over ranks
(gloo ranks on the CPU) against JAX's GSPMD step and the port's
single-controller step.

Each mesh spans a gloo world of spawned processes formed by the port's
Train backend: one position a rank for tp=2, pp=2 (2 microbatches), sp=2
under ``attention_impl`` "ring" and "xla" (the sequence gathered on the
first shard's rank) and tp=2 under ``megatron_rules()`` (the vocabulary
replicated, the embedding's and head's partial gradients summed across
ranks) on two ranks; dp=2 x tp=2, pp=2 x tp=2 and sp=2 x tp=2 (ring and
xla) on four; and sp=2 x tp=2 (ring and xla) and pp=2 x tp=2 on two,
each rank holding a shard's or a stage's two tp positions. Every rank
starts from JAX's seed-0 state carried across with
``from_jax_state(..., mesh=)`` (its own shards only), runs
``make_eval_step``, ``value_and_grad`` and ``forward``, and takes three
steps of ``make_train_step`` on the whole batch. JAX runs
``make_eval_step`` and ``make_train_step`` on the same ``MeshSpec`` of the
conftest's CPU devices; the bounds are the reference's own (loss 1e-4,
grad norm 1e-3 relative, ``tests/test_models.py:119-122``), and 1e-5
against the port's single-controller step on a mesh naming the CPU once
per position (both f32 on the CPU; only the order of the cross-rank sums
differs).

The spawned ranks import this module, so it imports JAX and the JAX
package only inside fixtures.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ray_tpu_torch.models import (PRESETS, forward, from_jax_state,
                                  make_eval_step, make_optimizer,
                                  make_train_step)
from ray_tpu_torch.models.train_step import value_and_grad
from ray_tpu_torch.models.transformer import (megatron_rules,
                                              param_logical_axes,
                                              param_shapes)
from ray_tpu_torch.parallel import (MeshSpec, build_mesh, gather_params,
                                    plan_train_memory, tree_specs)
from ray_tpu_torch.parallel.sharding import (all_gather_parts,
                                             gather_tensor, shard_slices)
from test_torch_collective import spawn_ranks
from test_torch_train_ranks import (Adam, Schedule, _batches, _get,
                                    _np_tree, _paths, _tensors, _torch)

STEPS = 3
# Each bounded wait of a world's ranks (their layouts run one after
# another, while other test files may run beside them).
JOIN_S = 300
# name: (mesh, world, attention_impl, Megatron rules, num_microbatches)
RUNS = {
    "tp2": (dict(tp=2), 2, "xla", False, None),
    "pp2": (dict(pp=2), 2, "xla", False, 2),
    "sp2-ring": (dict(sp=2), 2, "ring", False, None),
    "sp2-xla": (dict(sp=2), 2, "xla", False, None),
    "tp2-megatron": (dict(tp=2), 2, "xla", True, None),
    "dp2xtp2": (dict(dp=2, tp=2), 4, "xla", False, None),
    "pp2xtp2": (dict(pp=2, tp=2), 4, "xla", False, 2),
    "sp2xtp2-ring": (dict(sp=2, tp=2), 4, "ring", False, None),
    "sp2xtp2-xla": (dict(sp=2, tp=2), 4, "xla", False, None),
    # Two tp positions a rank: the sp shards or the stages across ranks.
    "sp2xtp2-ring-2ranks": (dict(sp=2, tp=2), 2, "ring", False, None),
    "sp2xtp2-xla-2ranks": (dict(sp=2, tp=2), 2, "xla", False, None),
    "pp2xtp2-2ranks": (dict(pp=2, tp=2), 2, "xla", False, 2),
}
NAMES = list(RUNS)
# Sampled gradients gathered across ranks: under pp each stage holds one
# of tiny's two layers.
GRADS = (("embed",), ("lm_head",), ("ln_f",), ("layers", 0, "attn", "wq"),
         ("layers", 1, "attn", "wk"), ("layers", 1, "mlp", "w_down"),
         ("layers", 0, "ln_attn"))


def _setup(name):
    spec, _, impl, megatron, mb = RUNS[name]
    cfg = dataclasses.replace(PRESETS["tiny"], attention_impl=impl)
    return spec, cfg, (megatron_rules() if megatron else None), mb


def _grad_sample(grads, path, specs, mesh):
    """One sampled gradient, whole: the position's layer gradients are
    stacked back to its (L/pp, ...) tensor and gathered with the stacked
    spec (dim 0 over pp), then the layer is taken."""
    if path[0] != "layers":
        parts = [None if g is None else g[path[0]] for g in grads]
        spec = specs[path[0]]
    else:
        rest = path[2:]
        parts = [None if g is None else torch.stack(
            [_get(layer, rest) for layer in g["layers"]]) for g in grads]
        spec = _get(specs, ("layers",) + rest)
    if mesh.world > 1:
        parts = all_gather_parts(parts, mesh)
    whole = gather_tensor(parts, spec, mesh)
    return (whole[path[1]] if path[0] == "layers" else whole).numpy()


def _run(name, mesh, np_state, batches):
    """On one rank (or on one process): eval, value_and_grad and forward
    on the carried state, then three steps; the gathered results."""
    _, cfg, rules, mb = _setup(name)
    specs = tree_specs(param_logical_axes(cfg), mesh, rules)
    state = from_jax_state(np_state, cfg, "cpu", mesh=mesh, rules=rules)
    first = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    out = dict(eval=float(make_eval_step(cfg, mesh, rules=rules,
                                         device="cpu")(state["params"],
                                                       first)))
    with FlopCounterMode(display=False) as flops:
        loss, grads = value_and_grad(state["params"], first, cfg,
                                     device="cpu", mesh=mesh, rules=rules,
                                     num_microbatches=mb)
    out["vg_flops"] = flops.get_total_flops()
    out["vg_loss"] = float(loss)
    out["grads"] = {path: _grad_sample(grads, path, specs, mesh)
                    for path in GRADS}
    del grads
    with torch.no_grad():
        out["logits"] = forward(state["params"], first["tokens"][:, :-1],
                                cfg, mesh, device="cpu", rules=rules,
                                num_microbatches=mb).numpy()
    bundle = make_train_step(cfg, mesh, rules=rules,
                             optimizer=make_optimizer(warmup_steps=1),
                             num_microbatches=mb, device="cpu")
    out["metrics"] = []
    for b in batches:
        state, m = bundle.step(state, {k: torch.as_tensor(v)
                                       for k, v in b.items()})
        out["metrics"].append((m["loss"], m["grad_norm"], m["step"]))
    opt = state["opt_state"]
    out["state"] = {k: _np_tree(gather_params(t, mesh, rules))
                    for k, t in (("params", state["params"]),
                                 ("mu", opt["mu"]), ("nu", opt["nu"]))}
    # Every tensor a rank holds equals its slice of the gathered state,
    # which takes each slice from its first holder: the replicas on other
    # ranks (tp's norm scales, dp's and sp's copies, the top-level
    # tensors of both stages) took identical updates.
    shapes = param_shapes(cfg)
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
    return out


def _ranks(rank, world, jobs):
    """All of a world's runs: rank 0's results, the others' held bytes,
    replica checks and FLOPs."""
    out = {name: _run(name, build_mesh(MeshSpec(**RUNS[name][0])), np_state,
                      batches) for name, np_state, batches in jobs}
    return out if rank == 0 else {
        k: {f: v[f] for f in ("held_bytes", "replicas_equal", "vg_flops")}
        for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's seed-0 state (plain picklable tuples), and per layout its
    GSPMD eval loss on the first batch and three steps' metrics and final
    state."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import PRESETS as JAX_PRESETS
    from ray_tpu.models import make_eval_step as jax_make_eval_step
    from ray_tpu.models import make_train_step as jax_make_train_step
    from ray_tpu.models.train_step import make_optimizer as jax_optimizer
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    from ray_tpu.parallel.sharding import LogicalAxisRules as JaxRules
    out = {}
    for name, (spec, _, impl, megatron, mb) in RUNS.items():
        cfg = dataclasses.replace(JAX_PRESETS["tiny"], attention_impl=impl)
        rules = (JaxRules.default().with_overrides(("vocab", None),
                                                   ("embed", None))
                 if megatron else None)
        n = MeshSpec(**spec).n_devices
        jmesh = jax_build_mesh(JaxMeshSpec(**spec),
                               devices=jax.devices()[:n])
        bundle = jax_make_train_step(cfg, jmesh, rules=rules,
                                     optimizer=jax_optimizer(warmup_steps=1),
                                     num_microbatches=mb)
        js = bundle.init(jax.random.key(0))
        batches = _batches()
        if "np_state" not in out:
            np_js = jax.tree.map(np.asarray, js)
            adam, sched = np_js["opt_state"][1][0], np_js["opt_state"][1][2]
            out["np_state"] = {"params": np_js["params"],
                               "opt_state": (Adam(adam.count, adam.mu,
                                                  adam.nu),
                                             Schedule(sched.count)),
                               "step": np_js["step"]}
        ev = float(jax_make_eval_step(cfg, jmesh, rules=rules)(
            js["params"], jax.tree.map(jnp.asarray, batches[0])))
        metrics = []
        for b in batches:
            js, m = bundle.step(js, jax.tree.map(jnp.asarray, b))
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        out[name] = dict(eval=ev, metrics=metrics,
                         state=jax.tree.map(np.asarray, js))
    return out


@pytest.fixture(scope="module")
def single(jax_side):
    """The port's single-controller runs, from the same state."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: _run(name, build_mesh(MeshSpec(**spec), devices=[
            "cpu"] * MeshSpec(**spec).n_devices), jax_side["np_state"],
            _batches()) for name, (spec, *_) in RUNS.items()}
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Each world's ranks: rank 0's results, the others' held bytes,
    replica checks and FLOPs."""
    out = {}
    for world in (2, 4):
        jobs = [(name, jax_side["np_state"], _batches())
                for name, (_, w, *_) in RUNS.items() if w == world]
        # A world runs four or five layouts before its ranks report.
        out[world] = spawn_ranks(_ranks, world,
                                 tmp_path_factory.mktemp(f"split{world}"),
                                 jobs, timeout=JOIN_S)
    return out


def _rank0(ranks, name):
    return ranks[RUNS[name][1]][0][name]


@pytest.mark.parametrize("name", NAMES)
def test_split_steps_match_jax(name, jax_side, ranks):
    from test_torch_train_step import _assert_params_close
    got, want = _rank0(ranks, name), jax_side[name]
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-4)
    for (loss, gnorm, step), (jl, jg, js) in zip(got["metrics"],
                                                 want["metrics"]):
        np.testing.assert_allclose(loss, jl, rtol=1e-4)
        np.testing.assert_allclose(gnorm, jg, rtol=1e-3)
        assert step == js
    _assert_params_close(_torch(got["state"]["params"]),
                         want["state"]["params"], lr_steps=STEPS - 1)


@pytest.mark.parametrize("name", NAMES)
def test_split_steps_match_the_single_controller(name, single, ranks):
    from test_torch_train_step import _assert_params_close
    got, want = _rank0(ranks, name), single[name]
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
def test_eval_value_and_grad_and_forward_per_rank(name, single, ranks):
    got, want = _rank0(ranks, name), single[name]
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-5)
    np.testing.assert_allclose(got["vg_loss"], want["vg_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["eval"], got["metrics"][0][0],
                               rtol=1e-6)
    for path in GRADS:
        np.testing.assert_allclose(got["grads"][path], want["grads"][path],
                                   rtol=1e-5, atol=1e-7, err_msg=str(path))
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_replicas_stay_bit_equal_and_bytes_match_the_planner(name, ranks):
    spec, world, *_ = RUNS[name]
    _, cfg, rules, mb = _setup(name)
    assert [r[name]["replicas_equal"] for r in ranks[world]] == [True] * world
    plan = plan_train_memory(cfg, MeshSpec(**spec), global_batch=4,
                             seq_len=16, rules=rules, num_microbatches=mb,
                             hbm_gib=1, world=world)
    held = [r[name]["held_bytes"] for r in ranks[world]]
    assert held == [plan.rank_params_bytes] * world
    assert plan.rank_opt_bytes == 2 * plan.rank_params_bytes


@pytest.mark.parametrize("name", NAMES)
def test_ranks_do_the_single_controllers_work(name, single, ranks):
    """value_and_grad's FLOPs summed over the ranks equal the single
    controller's: no rank computes what another computes for it (under
    ``megatron_rules()`` the unsplit head runs on the first tp position's
    rank alone)."""
    world = RUNS[name][1]
    assert (sum(r[name]["vg_flops"] for r in ranks[world])
            == single[name]["vg_flops"])
