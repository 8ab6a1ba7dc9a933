"""Parity of ray_tpu_torch's training with sp beside dp, fsdp, tp and pp
with the JAX package's on the CPU.

JAX runs its GSPMD ``forward``, ``loss_fn``, ``make_train_step`` and
``make_eval_step`` on dp=2 x sp=2, sp=2 x tp=2, fsdp=2 x sp=2 x tp=2 and
pp=2 x sp=2 meshes of the conftest's 8 CPU devices, under
``attention_impl`` "ring" (its ring per batch group and tp slice) and
"xla" (GSPMD gathers the sequence around plain attention); the port runs
on meshes that name the CPU n times, each batch group's sequence split
over its sp positions. ``PRESETS["tiny"]`` is f32: logits and loss within
1e-4, three steps' loss within 1e-4 and grad norm within 1e-3 relative
(the bounds of tests/test_torch_train_mesh.py), the planner's state bytes
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu.models import forward as jax_forward
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models import loss_fn as jax_loss_fn
from ray_tpu.models import make_eval_step as jax_make_eval_step
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models.train_step import make_optimizer as jax_make_optimizer
from ray_tpu.models.transformer import \
    param_logical_axes as jax_param_logical_axes
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu.parallel.planner import plan_train_memory as jax_plan
from ray_tpu.parallel.sharding import tree_shardings as jax_tree_shardings
from ray_tpu_torch.models import (PRESETS, forward, from_jax_params,
                                  from_jax_state, loss_fn, make_eval_step,
                                  make_optimizer, make_train_step)
from ray_tpu_torch.parallel import (MeshSpec, build_mesh, gather_params,
                                    plan_train_memory, shard_params)
from test_torch_train_step import _check_state

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
LAYOUTS = [dict(dp=2, sp=2), dict(sp=2, tp=2), dict(fsdp=2, sp=2, tp=2),
           dict(pp=2, sp=2)]
STEPS = 3


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
            build_mesh(MeshSpec(**spec), devices=[CPU] * n))


def _cfgs(impl):
    return (dataclasses.replace(CFG, attention_impl=impl),
            dataclasses.replace(JCFG, attention_impl=impl))


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(JCFG, jax.random.key(0))


@pytest.mark.parametrize("impl", ["ring", "xla"])
@pytest.mark.parametrize("spec", LAYOUTS)
def test_forward_and_loss_match_jax(jparams, spec, impl):
    """forward() and loss_fn() (padded targets) under the mesh against
    JAX's on the same mesh shape, its params placed by the default
    rules."""
    cfg, jcfg = _cfgs(impl)
    jmesh, mesh = _meshes(spec)
    placed = jax.device_put(jparams, jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh))
    params = from_jax_params(_np(jparams), cfg, "cpu")
    toks = _tokens((4, 16), 1)
    want = np.asarray(jax.jit(lambda p, t: jax_forward(p, t, jcfg, jmesh))(
        placed, jnp.asarray(toks)))
    with torch.no_grad():
        got = forward(params, toks, cfg, mesh, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    inputs, targets = _tokens((4, 16), 2), _tokens((4, 16), 3)
    targets[0, 7:] = 0                 # padding id 0 carries no weight
    batch = {"inputs": inputs, "targets": targets}
    want = float(jax.jit(lambda p, b: jax_loss_fn(p, b, jcfg, jmesh))(
        placed, jax.tree.map(jnp.asarray, batch)))
    with torch.no_grad():
        got = loss_fn(params, jax.tree.map(torch.from_numpy, batch), cfg,
                      mesh, device="cpu")
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, **TOL)


def _gathered_state(ts, mesh):
    return {"params": gather_params(ts["params"], mesh),
            "opt_state": {**ts["opt_state"],
                          "mu": gather_params(ts["opt_state"]["mu"], mesh),
                          "nu": gather_params(ts["opt_state"]["nu"], mesh)},
            "step": ts["step"]}


@pytest.mark.parametrize("spec,impl", [(s, "ring") for s in LAYOUTS]
                         + [(LAYOUTS[1], "xla"), (LAYOUTS[3], "xla")])
def test_three_steps_match_jax(spec, impl):
    """Three steps of make_train_step from a JAX state carried across,
    against JAX's make_train_step on the same mesh: loss and grad norm
    each step, the gathered params, mu and nu after. The sp positions'
    gradients of each replicated slice are summed, as dp's are (the ring,
    or the gather around plain attention, recomputes through each
    checkpointed layer)."""
    cfg, jcfg = _cfgs(impl)
    jmesh, mesh = _meshes(spec)
    jb = jax_make_train_step(jcfg, jmesh,
                             optimizer=jax_make_optimizer(warmup_steps=1))
    tb = make_train_step(cfg, mesh, optimizer=make_optimizer(warmup_steps=1),
                         device="cpu")
    js = jb.init(jax.random.key(0))
    ts = from_jax_state(_np(js), cfg, "cpu", mesh=mesh)
    batch = {"tokens": _tokens((8, 33), 0)}
    for i in range(STEPS):
        js, jm = jb.step(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tb.step(ts, jax.tree.map(torch.from_numpy, batch))
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-3)
        assert tm["step"] == int(jm["step"]) == i + 1
    _check_state(_gathered_state(ts, mesh), _np(js), lr_steps=STEPS - 1)


@pytest.mark.parametrize("spec", LAYOUTS)
def test_eval_step_matches_jax(jparams, spec):
    cfg, jcfg = _cfgs("ring")
    jmesh, mesh = _meshes(spec)
    placed = jax.device_put(jparams, jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh))
    toks = _tokens((8, 17), 5)
    want = float(jax_make_eval_step(jcfg, jmesh)(
        placed, {"tokens": jnp.asarray(toks)}))
    shards = shard_params(from_jax_params(_np(jparams), cfg, "cpu"), mesh)
    got = make_eval_step(cfg, mesh, device="cpu")(
        shards, {"tokens": torch.from_numpy(toks)})
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("spec", LAYOUTS)
def test_planner_state_bytes_match_jax(spec):
    """The planner's per-position state under sp beside other axes equals
    JAX's, byte for byte, at the 8B config; a position's activations hold
    its sequence shard (S / sp tokens of each row), as JAX reckons."""
    want = jax_plan(JAX_PRESETS["8b-gqa"], JaxMeshSpec(**spec),
                    global_batch=8, seq_len=2048, hbm_gib=80.0)
    got = plan_train_memory(PRESETS["8b-gqa"], MeshSpec(**spec),
                            global_batch=8, seq_len=2048, hbm_gib=80.0)
    assert (got.params_bytes, got.grads_bytes, got.opt_bytes) == \
        (want.params_bytes, want.grads_bytes, want.opt_bytes)
    unsplit = plan_train_memory(
        PRESETS["8b-gqa"], MeshSpec(**dict(spec, sp=1)), global_batch=8,
        seq_len=2048, hbm_gib=80.0)
    assert 2 * got.activation_bytes == unsplit.activation_bytes


@pytest.mark.parametrize("spec", [dict(dp=2, sp=2), dict(sp=2, tp=2)])
def test_gradient_reaches_layers_behind_a_frozen_embedding(spec):
    """Each sharded layer is checkpointed on its flat inputs (the
    reentrant checkpoint, whose inner backward runs only where an input
    requires grad): with the embedding frozen and only wq trained, wq's
    gradient under the mesh equals the unsharded one's."""
    cfg, _ = _cfgs("ring")
    _, mesh = _meshes(spec)
    params = from_jax_params(_np(jax_init_params(JCFG, jax.random.key(0))),
                             cfg, "cpu")
    batch = {"tokens": torch.from_numpy(_tokens((4, 17), 7))}
    grads = []
    for m in (None, mesh):
        wq = params["layers"]["attn"]["wq"].clone().requires_grad_()
        tree = {**params, "layers": {**params["layers"], "attn": {
            **params["layers"]["attn"], "wq": wq}}}
        loss_fn(tree, batch, cfg, m, device="cpu").backward()
        grads.append(wq.grad)
    assert grads[1] is not None and grads[1].abs().max() > 0
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                               rtol=1e-4, atol=1e-6)
