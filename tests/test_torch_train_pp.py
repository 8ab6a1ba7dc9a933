"""Parity of ray_tpu_torch's pipeline-parallel training with the JAX
package's on the CPU.

The ports of ``tests/test_parallel_advanced.py:73-89`` and ``:158-211``.
JAX runs ``forward``, ``loss_fn`` and ``make_train_step`` on pp meshes of
the conftest's virtual CPU devices, its params placed by the default
rules (the layer stack over pp); the port's meshes name the CPU n times,
its params and state carried across with ``from_jax_params`` and
``from_jax_state(..., mesh=)``. ``PRESETS["tiny"]`` is f32: forward, loss
and gradients within 1e-4, and the step trajectories at the reference's
own rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu.models import forward as jax_forward
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models import loss_fn as jax_loss_fn
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models.train_step import make_optimizer as jax_make_optimizer
from ray_tpu.models.transformer import \
    param_logical_axes as jax_param_logical_axes
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu.parallel.sharding import tree_shardings as jax_tree_shardings
from ray_tpu_torch.models import (PRESETS, forward, from_jax_params,
                                  from_jax_state, loss_fn, make_eval_step,
                                  make_optimizer, make_train_step)
from ray_tpu_torch.models.train_step import value_and_grad
from ray_tpu_torch.parallel import (MeshSpec, build_mesh, shard_params,
                                    tree_specs)
from ray_tpu_torch.parallel.sharding import gather_tensor

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
TOL = dict(rtol=1e-4, atol=1e-4)
FWD_MESH = dict(pp=2, fsdp=2, tp=2)


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


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab_size, shape).astype(np.int32)


def _meshes(spec):
    n = MeshSpec(**spec).n_devices
    return (jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:n]),
            build_mesh(MeshSpec(**spec), devices=["cpu"] * n))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _stacked(tree):
    """A position's gradient tree with its per-layer list stacked back
    into (L/pp, ...) tensors."""
    layers = tree["layers"]
    out = {k: tree[k] for k in ("embed", "ln_f", "lm_head")}

    def stack(path):
        parts = []
        for lyr in layers:
            for k in path:
                lyr = lyr[k]
            parts.append(lyr)
        return torch.stack(parts)
    out["layers"] = {
        "attn": {k: stack(("attn", k)) for k in ("wq", "wk", "wv", "wo")},
        "mlp": {k: stack(("mlp", k)) for k in ("w_gate", "w_up", "w_down")},
        "ln_attn": stack(("ln_attn",)), "ln_mlp": stack(("ln_mlp",))}
    return out


def _gathered(trees, mesh):
    """{name: full tensor} of per-position (stacked) trees."""
    specs = dict(_leaves(tree_specs(jax_param_logical_axes(JCFG), mesh)))
    per_pos = [dict(_leaves(t)) for t in trees]
    return {name: gather_tensor([p[name] for p in per_pos], spec, mesh)
            for name, spec in specs.items()}


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(JCFG, jax.random.key(0))


def test_forward_and_loss_under_pp_match_jax(jparams):
    """forward() and loss_fn() on pp=2 x fsdp=2 x tp=2 with 2 microbatches
    against JAX's on the same mesh, its params placed by the default
    rules (the port of :73-89, at f32 tolerance); the default microbatch
    count is pp; make_eval_step on the same mesh."""
    jmesh, mesh = _meshes(FWD_MESH)
    placed = jax.device_put(jparams, jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh))
    params = from_jax_params(_np(jparams), CFG, "cpu")
    toks = _tokens((4, 32), 0)
    want = np.asarray(jax.jit(lambda p, t: jax_forward(
        p, t, JCFG, jmesh, num_microbatches=2))(placed, jnp.asarray(toks)))
    with torch.no_grad():
        got = forward(params, toks, CFG, mesh, device="cpu",
                      num_microbatches=2)
        flat = forward(params, toks, CFG, device="cpu")
        default = forward(params, toks, CFG, mesh, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), **TOL)
    assert torch.equal(default, got)
    batch = {"inputs": _tokens((4, 12), 1), "targets": _tokens((4, 12), 2)}
    batch["targets"][0, 7:] = 0            # padding id 0 carries no weight
    jloss = float(jax.jit(lambda p, b: jax_loss_fn(
        p, b, JCFG, jmesh, num_microbatches=2))(
            placed, jax.tree.map(jnp.asarray, batch)))
    tb = jax.tree.map(torch.from_numpy, batch)
    with torch.no_grad():
        got = loss_fn(params, tb, CFG, mesh, device="cpu",
                      num_microbatches=2)
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), jloss, **TOL)
    ev = make_eval_step(CFG, mesh, device="cpu")(params, tb)
    np.testing.assert_allclose(float(ev), jloss, **TOL)


def test_pp_gradients_match_jax(jparams):
    """value_and_grad on pp=2 x fsdp=2 x tp=2 (2 microbatches): the loss
    and every gradient, gathered, against jax.grad of JAX's loss_fn on
    the same mesh."""
    jmesh, mesh = _meshes(FWD_MESH)
    placed = jax.device_put(jparams, jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh))
    toks = _tokens((4, 33), 3)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(
        p, {"tokens": jnp.asarray(toks)}, JCFG, jmesh,
        num_microbatches=2)))(placed)
    params = shard_params(from_jax_params(_np(jparams), CFG, "cpu"), mesh)
    loss, grads = value_and_grad(params, {"tokens": torch.from_numpy(toks)},
                                 CFG, device="cpu", mesh=mesh,
                                 num_microbatches=2)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    got = _gathered([_stacked(g) for g in grads], mesh)
    for name, want in _leaves(_np(jg)):
        np.testing.assert_allclose(got[name].numpy(), want, err_msg=name,
                                   **TOL)


@pytest.fixture(scope="module")
def jax_pp_bundle():
    """JAX's make_train_step on pp=2 x dp=2 x tp=2: one compile."""
    jmesh, _ = _meshes(dict(pp=2, dp=2, tp=2))
    return jax_make_train_step(JCFG, jmesh,
                               optimizer=jax_make_optimizer(warmup_steps=1),
                               num_microbatches=4)


def test_from_jax_state_on_a_pp_mesh_is_exact(jax_pp_bundle):
    """A JAX pp state one step in, carried into the port's pp layout: each
    position's params, mu and nu equal the JAX state's addressable shard
    on that position's device; each position holds its stage's L/pp
    layers."""
    jmesh, mesh = _meshes(dict(pp=2, dp=2, tp=2))
    js = jax_pp_bundle.init(jax.random.key(1))
    js, _ = jax_pp_bundle.step(js, {"tokens": jnp.asarray(
        _tokens((8, 33), 4))})
    ts = from_jax_state(_np(js), CFG, "cpu", mesh=mesh)
    adam = js["opt_state"][1][0]
    for mine, theirs in ((ts["params"], js["params"]),
                         (ts["opt_state"]["mu"], adam.mu),
                         (ts["opt_state"]["nu"], adam.nu)):
        per_pos = [dict(_leaves(t)) for t in mine]
        for name, arr in _leaves(theirs):
            by_dev = {s.device: np.asarray(s.data)
                      for s in arr.addressable_shards}
            for i, dev in enumerate(jmesh.devices.flat):
                np.testing.assert_array_equal(per_pos[i][name].numpy(),
                                              by_dev[dev], err_msg=name)
    assert ts["step"] == 1 and ts["opt_state"]["count"] == 1


def test_pp_training_step_decreases_loss(jax_pp_bundle):
    """pp=2 x dp=2 x tp=2 with 4 microbatches (the port of :158-182): the
    layer specs start with "pp", each position holds L/pp layers of its
    stage, and the loss falls over four steps; the steps equal JAX's."""
    jmesh, mesh = _meshes(dict(pp=2, dp=2, tp=2))
    bundle = make_train_step(CFG, mesh, optimizer=make_optimizer(
        warmup_steps=1), num_microbatches=4, device="cpu")
    for name, spec in _leaves(bundle.state_specs["params"]["layers"]):
        assert spec[0] == "pp", (name, spec)
    assert bundle.state_specs["opt_state"]["mu"] == \
        bundle.state_specs["params"]
    js = jax_pp_bundle.init(jax.random.key(0))
    assert js["params"]["layers"]["attn"]["wq"].sharding.spec[0] == "pp"
    state = from_jax_state(_np(js), CFG, "cpu", mesh=mesh)
    full = _np(js["params"])["layers"]["attn"]["wq"]
    per = CFG.num_layers // 2
    for i, coord in enumerate(mesh.coords()):
        wq = state["params"][i]["layers"]["attn"]["wq"]
        assert wq.shape[0] == per
        stage = coord[0]
        np.testing.assert_array_equal(
            wq.numpy(), full[stage * per:(stage + 1) * per][
                :, :, coord[4] * 4:(coord[4] + 1) * 4])
    batch = {"tokens": _tokens((8, 33), 0)}
    losses = []
    for _ in range(4):
        js, jm = jax_pp_bundle.step(js, jax.tree.map(jnp.asarray, batch))
        state, m = bundle.step(state, jax.tree.map(torch.from_numpy,
                                                   batch))
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-3)
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-3)
        losses.append(m["loss"])
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_pp_training_matches_single_device_and_jax():
    """pp=2 with 2 microbatches, three steps from JAX's seed-0 state (the
    port of :184-211): the port's losses against the port's unsharded
    trajectory and JAX's pp=2 trajectory, at the reference's rtol 1e-3."""
    batch = {"tokens": _tokens((4, 33), 0)}
    jmesh, mesh = _meshes(dict(pp=2))
    jb = jax_make_train_step(JCFG, jmesh,
                             optimizer=jax_make_optimizer(warmup_steps=1),
                             num_microbatches=2)
    js = jb.init(jax.random.key(0))
    init = _np(js)
    jax_losses = []
    for _ in range(3):
        js, jm = jb.step(js, jax.tree.map(jnp.asarray, batch))
        jax_losses.append(float(jm["loss"]))

    def run(m):
        tb = make_train_step(CFG, m, optimizer=make_optimizer(
            warmup_steps=1), num_microbatches=2, device="cpu")
        ts = from_jax_state(init, CFG, "cpu", mesh=m)
        out = []
        for _ in range(3):
            ts, tm = tb.step(ts, jax.tree.map(torch.from_numpy, batch))
            out.append(tm["loss"])
        return out
    ref, pp = run(None), run(mesh)
    np.testing.assert_allclose(pp, ref, rtol=1e-3)
    np.testing.assert_allclose(pp, jax_losses, rtol=1e-3)
