"""The per-rank train step (one process per GPU; gloo ranks on the CPU)
against JAX's GSPMD step and the port's single-controller step.

Each mesh spans a gloo world of spawned processes formed by the port's
Train backend: dp=2, fsdp=2 and dp=2 x tp=2 (tp inside each rank) on two
ranks, dp=2 x fsdp=2 on two and on four (tp, sp and pp across ranks:
``tests/test_torch_train_split_ranks.py``). Every rank starts from the JAX
state carried across with ``from_jax_state(..., mesh=)`` (its own shards
only), takes three steps of ``make_train_step`` on the whole batch, and
runs ``make_eval_step``, ``value_and_grad`` and ``forward``. JAX runs
``make_train_step`` on the same ``MeshSpec`` of the conftest's CPU
devices; the bounds are the reference's own (loss 1e-4, grad norm 1e-3
relative, ``tests/test_models.py:119-122``), and 1e-5 against the port's
single-controller step on a mesh naming the CPU once per position (both
f32 on the CPU; only the order of the cross-rank sums differs).

The spawned ranks import this module, so it imports JAX and the JAX
package only inside fixtures and tests.
"""

import collections
import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import (PRESETS, forward, from_jax_state,
                                  make_eval_step, make_optimizer,
                                  make_train_step)
from ray_tpu_torch.models.train_step import value_and_grad
from ray_tpu_torch.parallel import (MeshSpec, build_mesh, gather_params,
                                    plan_train_memory, tree_specs)
from ray_tpu_torch.parallel.sharding import (all_gather_parts,
                                             gather_tensor, shard_slices)
from ray_tpu_torch.models.transformer import (param_logical_axes,
                                              param_shapes)
from test_torch_collective import spawn_ranks

CFG = PRESETS["tiny"]
STEPS = 3
SPECS = {"dp2": dict(dp=2), "fsdp2": dict(fsdp=2),
         "dp2xfsdp2": dict(dp=2, fsdp=2), "dp2xtp2": dict(dp=2, tp=2)}
RUNS = [("dp2", 2), ("fsdp2", 2), ("dp2xfsdp2", 2), ("dp2xfsdp2", 4),
        ("dp2xtp2", 2)]
IDS = [f"{name}-on-{world}-ranks" for name, world in RUNS]
# Sampled gradients gathered across ranks.
GRADS = (("embed",), ("lm_head",), ("layers", 0, "attn", "wq"),
         ("layers", 1, "mlp", "w_down"))
# optax's chained state, as plain picklable tuples (from_jax_state finds
# the Adam moments and the schedule's count by their fields).
Adam = collections.namedtuple("Adam", ["count", "mu", "nu"])
Schedule = collections.namedtuple("Schedule", ["count"])


def _batches():
    return [{"tokens": np.random.default_rng(20 + i).integers(
        1, CFG.vocab_size, (4, 17)).astype(np.int64)} for i in range(STEPS)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _run(mesh, np_state, batches, sample_grads=True):
    """On one rank (or on one process): eval, value_and_grad and forward
    on the carried state, then three steps; the gathered results."""
    specs = tree_specs(param_logical_axes(CFG), mesh)
    state = from_jax_state(np_state, CFG, "cpu", mesh=mesh)
    first = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    out = dict(eval=float(make_eval_step(CFG, mesh, device="cpu")(
        state["params"], first)))
    loss, grads = value_and_grad(state["params"], first, CFG, device="cpu",
                                 mesh=mesh)
    out["vg_loss"] = float(loss)
    out["grads"] = {}
    for path in GRADS:
        spec = _get(specs, [k for k in path if not isinstance(k, int)])
        spec = spec[1:] if len(path) > 1 else spec
        parts = [None if g is None else _get(g, path) for g in grads]
        if mesh.world > 1:
            parts = all_gather_parts(parts, mesh)
        out["grads"][path] = gather_tensor(parts, spec, mesh).numpy()
    out["logits"] = forward(state["params"], first["tokens"][:, :-1], CFG,
                            mesh, device="cpu").numpy()
    bundle = make_train_step(CFG, mesh,
                             optimizer=make_optimizer(warmup_steps=1),
                             device="cpu")
    out["metrics"] = []
    for b in batches:
        state, m = bundle.step(state, {k: torch.as_tensor(v)
                                       for k, v in b.items()})
        out["metrics"].append((m["loss"], m["grad_norm"], m["step"]))
    opt = state["opt_state"]
    out["state"] = {k: _np_tree(gather_params(t, mesh))
                    for k, t in (("params", state["params"]),
                                 ("mu", opt["mu"]), ("nu", opt["nu"]))}
    # Every tensor a rank holds equals its slice of the gathered state,
    # which takes each slice from its first holder: dp replicas on other
    # ranks took identical updates.
    shapes = param_shapes(CFG)
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


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _ranks(rank, world, jobs, example_dir):
    """All of a world's runs, then (on two ranks) the layouts that must
    raise and the example loop's checkpoint and resume."""
    torch.set_num_threads(1)
    out = {name: _run(build_mesh(MeshSpec(**SPECS[name])), np_state,
                      batches) for name, np_state, batches in jobs}
    if world == 2:
        out["raised"] = _raised()
        out["example"] = _example(rank, example_dir)
    return out if rank == 0 else {
        k: {f: v[f] for f in ("held_bytes", "replicas_equal")}
        for k, v in out.items() if k in SPECS}


def _raised():
    """What still raises on a mesh over two ranks: layouts that split a
    group unevenly or put a split group's rank on two devices
    (ValueError), and serving (NotImplementedError). The free-standing
    ring, pipeline and MoE layer run there (their parity with JAX is in
    tests/test_torch_{ring_attention,pipeline,moe}_ranks.py): what each
    returns to this rank."""
    from ray_tpu_torch.models.moe import MoEConfig, moe_layer
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.parallel.pipeline import pipeline_spmd
    x = torch.arange(2 * 4 * 2 * 8, dtype=torch.float32).reshape(
        2, 4, 2, 8) / 64
    sp2 = build_mesh(MeshSpec(sp=2))
    calls = {
        "sp3xtp2": lambda: make_train_step(CFG, build_mesh(
            MeshSpec(sp=3, tp=2), devices=["cpu"] * 3), device="cpu"),
        "tp4-two-devices": lambda: make_train_step(CFG, build_mesh(
            MeshSpec(tp=4), devices=["cpu", "cpu:0"]), device="cpu"),
        "serve": lambda: build_mesh(MeshSpec(dp=2)).serve_axes(),
        "ring_attention": lambda: ring_attention(x, x, x, sp2),
        "pipeline_spmd": lambda: pipeline_spmd(
            lambda w, h: h * w[0], torch.full((2, 1), 2.0), x,
            mesh=build_mesh(MeshSpec(pp=2)), num_microbatches=2),
        "moe_layer": lambda: moe_layer(
            {"router": torch.ones(8, 4), "w_gate": torch.ones(4, 8, 16),
             "w_up": torch.ones(4, 8, 16), "w_down": torch.ones(4, 16, 8)},
            torch.ones(1, 4, 8), MoEConfig(d_model=8, d_ff=16,
                                           num_experts=4,
                                           dtype=torch.float32),
            build_mesh(MeshSpec(fsdp=2)))[0],
    }
    raised = {}
    for name, call in calls.items():
        try:
            # As numpy: a tensor sent through the results queue would
            # share memory with a rank that exits.
            raised[name] = ("ran", call().detach().numpy())
        except (ValueError, NotImplementedError) as e:
            raised[name] = (type(e).__name__, str(e))
    return raised


def _example(rank, root):
    """The example loop: three steps with a checkpoint after each, and
    two steps then a resume from the second checkpoint."""
    from ray_tpu_torch.train.examples.transformer_example import (
        transformer_train_loop)
    config = {"preset": "tiny", "mesh": {"dp": 1, "fsdp": 2}, "steps": 3,
              "batch": 4, "seq": 16, "seed": 7, "checkpoint_every": 1}
    whole = transformer_train_loop(dict(config, checkpoint_dir=f"{root}/a"))
    first = transformer_train_loop(dict(config, steps=2,
                                        checkpoint_dir=f"{root}/b"))
    reports = []
    rest = transformer_train_loop(
        dict(config, checkpoint_dir=f"{root}/c",
             resume_from_checkpoint=f"{root}/b/step_2"),
        report=lambda metrics, ckpt: reports.append(ckpt))
    a = torch.load(f"{root}/a/step_3/rank_{rank}.pt")
    c = torch.load(f"{root}/c/step_3/rank_{rank}.pt")
    same = all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(c)))
    return dict(whole=whole, resumed=first + rest, same_state=same,
                reports=reports, files=sorted(os.listdir(f"{root}/c")))


def _flat(state):
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif torch.is_tensor(node):
            out.append(node)
    walk(state)
    return out


@pytest.fixture(scope="module")
def jax_side():
    """Per layout: JAX's init state (plain picklable tuples) and its three
    GSPMD steps' metrics and final state."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import PRESETS as JAX_PRESETS
    from ray_tpu.models import make_train_step as jax_make_train_step
    from ray_tpu.models.train_step import make_optimizer as jax_optimizer
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    out = {}
    for name, spec in SPECS.items():
        n = MeshSpec(**spec).n_devices
        jmesh = jax_build_mesh(JaxMeshSpec(**spec),
                               devices=jax.devices()[:n])
        bundle = jax_make_train_step(JAX_PRESETS["tiny"], jmesh,
                                     optimizer=jax_optimizer(warmup_steps=1))
        js = bundle.init(jax.random.key(0))
        np_js = jax.tree.map(np.asarray, js)
        adam, sched = np_js["opt_state"][1][0], np_js["opt_state"][1][2]
        np_state = {"params": np_js["params"],
                    "opt_state": (Adam(adam.count, adam.mu, adam.nu),
                                  Schedule(sched.count)),
                    "step": np_js["step"]}
        metrics = []
        for b in _batches():
            js, m = bundle.step(js, jax.tree.map(jnp.asarray, b))
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        out[name] = dict(np_state=np_state, metrics=metrics,
                         state=jax.tree.map(np.asarray, js))
    return out


@pytest.fixture(scope="module")
def single(jax_side):
    """The port's single-controller runs, from the same states."""
    torch.set_num_threads(1)
    return {name: _run(build_mesh(MeshSpec(**spec), devices=[
        "cpu"] * MeshSpec(**spec).n_devices), jax_side[name]["np_state"],
        _batches()) for name, spec in SPECS.items()}


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Each world's ranks: rank 0's results, the others' held bytes and
    replica checks."""
    out = {}
    for world in (2, 4):
        jobs = [(name, jax_side[name]["np_state"], _batches())
                for name, w in RUNS if w == world]
        tmp = tmp_path_factory.mktemp(f"world{world}")
        got = spawn_ranks(_ranks, world, tmp, jobs, str(tmp / "example"))
        out[world] = got
    return out


@pytest.mark.parametrize("name,world", RUNS, ids=IDS)
def test_per_rank_steps_match_jax(name, world, jax_side, ranks):
    from test_torch_train_step import _assert_params_close
    got = ranks[world][0][name]
    want = jax_side[name]
    for (loss, gnorm, step), (jl, jg, js) in zip(got["metrics"],
                                                 want["metrics"]):
        np.testing.assert_allclose(loss, jl, rtol=1e-4)
        np.testing.assert_allclose(gnorm, jg, rtol=1e-3)
        assert step == js
    _assert_params_close(_torch(got["state"]["params"]),
                         want["state"]["params"], lr_steps=STEPS - 1)


@pytest.mark.parametrize("name,world", RUNS, ids=IDS)
def test_per_rank_steps_match_the_single_controller(name, world, single,
                                                    ranks):
    from test_torch_train_step import _assert_params_close
    got, want = ranks[world][0][name], single[name]
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


@pytest.mark.parametrize("name,world", RUNS, ids=IDS)
def test_eval_value_and_grad_and_forward_per_rank(name, world, single,
                                                  ranks):
    got, want = ranks[world][0][name], single[name]
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-5)
    np.testing.assert_allclose(got["vg_loss"], want["vg_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["eval"], got["metrics"][0][0],
                               rtol=1e-6)
    for path in GRADS:
        np.testing.assert_allclose(got["grads"][path], want["grads"][path],
                                   rtol=1e-5, atol=1e-7, err_msg=str(path))
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name,world", RUNS, ids=IDS)
def test_replicas_stay_bit_equal_and_bytes_match_the_planner(name, world,
                                                             ranks):
    assert [r[name]["replicas_equal"] for r in ranks[world]] == [True] * world
    plan = plan_train_memory(CFG, MeshSpec(**SPECS[name]), global_batch=4,
                             seq_len=16, hbm_gib=1, world=world)
    held = [r[name]["held_bytes"] for r in ranks[world]]
    assert held == [plan.rank_params_bytes] * world
    assert plan.rank_opt_bytes == 2 * plan.rank_params_bytes


def test_uneven_splits_serving_and_free_standing_layers_across_ranks_raise(
        ranks):
    """Uneven splits and serving raise across ranks; the free-standing
    ring, pipeline and MoE layer, which raised naming ROADMAP items 14-16
    before they ran per rank, now give rank 0 its part: the ring its
    sequence shard of plain attention, the pipeline (two stages that each
    double) the whole output on the last stage's rank and nothing here,
    the MoE layer y of its run of the tokens."""
    from ray_tpu_torch.ops.flash_attention import reference_attention
    raised = ranks[2][0]["raised"]
    assert raised["sp3xtp2"][0] == "ValueError"
    assert "sp group of 3 positions splits unevenly" in raised["sp3xtp2"][1]
    assert raised["tp4-two-devices"][0] == "ValueError"
    assert "must share one" in raised["tp4-two-devices"][1]
    assert raised["serve"][0] == "NotImplementedError"
    assert "2 processes" in raised["serve"][1]
    x = torch.arange(2 * 4 * 2 * 8, dtype=torch.float32).reshape(
        2, 4, 2, 8) / 64
    kind, got = raised["ring_attention"]
    assert kind == "ran"
    np.testing.assert_allclose(
        got, reference_attention(x, x, x, causal=True)[:, :2].numpy(),
        rtol=1.3e-6, atol=1e-5)
    assert raised["pipeline_spmd"][0] == "ran"
    assert raised["pipeline_spmd"][1].shape == (0,)
    kind, y = raised["moe_layer"]
    assert kind == "ran" and y.shape == (2, 8)


def test_example_resume_equals_an_uninterrupted_run_bit_for_bit(ranks):
    ex = ranks[2][0]["example"]
    assert ex["resumed"] == ex["whole"]
    assert [m["step"] for m in ex["whole"]] == [0, 1, 2]
    assert ex["whole"][-1]["loss"] < ex["whole"][0]["loss"]
    assert ex["same_state"]
    assert ex["reports"][-1].endswith("c/step_3")
    assert ex["files"] == ["step_3"]
