"""Parity of ray_tpu_torch's sharded training with the JAX package's on the
CPU.

The JAX side runs ``forward``, ``loss_fn``, ``make_train_step`` and
``make_eval_step`` on meshes of the conftest's 8 virtual CPU devices with
its plain attention, its params placed by ``tree_shardings``; the port's
meshes name the CPU 8 times (a position is not a device), its state
carried across with ``from_jax_state(..., mesh=)``. ``PRESETS["tiny"]`` is
f32, so the tolerances are f32 ones: 1e-4 for forward and loss, and the
reference's own sharded-vs-single tolerances for the steps
(``tests/test_models.py:119-122``).
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
from ray_tpu.parallel.sharding import LogicalAxisRules as JaxRules
from ray_tpu.parallel.sharding import shard_batch as jax_shard_batch
from ray_tpu.parallel.sharding import tree_shardings as jax_tree_shardings
from ray_tpu_torch.models import (PRESETS, forward, from_jax_params,
                                  from_jax_state, loss_fn, make_eval_step,
                                  make_optimizer, make_train_step)
from ray_tpu_torch.models.train_step import value_and_grad
from ray_tpu_torch.models.transformer import megatron_rules
from ray_tpu_torch.parallel import (LogicalAxisRules, MeshSpec, build_mesh,
                                    gather_params, shard_batch, shard_params,
                                    tree_specs)
from ray_tpu_torch.parallel.sharding import gather_tensor
from test_torch_train_step import _assert_params_close, _check_state

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
MESH = dict(dp=2, fsdp=2, tp=2)
FWD_MESHES = [dict(dp=2), dict(fsdp=2), dict(tp=2), dict(fsdp=2, tp=2),
              MESH]
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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _np_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _optimizer(jax_side: bool):
    return (jax_make_optimizer if jax_side else make_optimizer)(
        warmup_steps=1)


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(JCFG, jax.random.key(0))


@pytest.fixture(scope="module")
def jax_bundle():
    """JAX's make_train_step on the 2x2x2 mesh: one compile for the file."""
    jmesh, _ = _meshes(MESH)
    return jax_make_train_step(JCFG, jmesh, optimizer=_optimizer(True))


def _batch(form: str, B: int, seed: int):
    if form == "tokens":
        return {"tokens": _tokens((B, 17), seed)}
    inputs, targets = _tokens((B, 12), seed), _tokens((B, 12), seed + 1)
    targets[0, 7:] = 0                 # padding id 0 carries no weight
    targets[-1, :3] = 0
    return {"inputs": inputs, "targets": targets}


@pytest.mark.parametrize("spec", FWD_MESHES)
def test_forward_and_loss_under_a_mesh_match_jax(jparams, spec):
    """forward() and loss_fn() under the mesh, against JAX's on the same
    mesh shape with its params placed by the default rules; loss_fn in
    both batch forms, the targets padded."""
    jmesh, mesh = _meshes(spec)
    placed = jax.device_put(jparams, jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh))
    params = from_jax_params(_np(jparams), CFG, "cpu")
    toks = _tokens((4, 19), 1)
    want = np.asarray(jax.jit(lambda p, t: jax_forward(p, t, JCFG, jmesh))(
        placed, jnp.asarray(toks)))
    with torch.no_grad():
        got = forward(params, toks, CFG, mesh, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jloss = jax.jit(lambda p, b: jax_loss_fn(p, b, JCFG, jmesh))
    for form in ("tokens", "targets"):
        batch = _batch(form, 4, 2)
        want = float(jloss(placed, jax.tree.map(jnp.asarray, batch)))
        with torch.no_grad():
            got = loss_fn(params, jax.tree.map(torch.from_numpy, batch),
                          CFG, mesh, device="cpu")
        assert got.dim() == 0 and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("spec", [MESH, dict(fsdp=2, tp=2),
                                  dict(fsdp=2, sp=2, tp=2)])
def test_shard_params_and_gather_bit_equal_to_jax(jparams, spec, dtype):
    """Under the default rules each position's tensor of every leaf is, bit
    for bit, the shard jax.device_put places on the mesh's device of that
    position; gather_params gives the params back bit for bit."""
    jmesh, mesh = _meshes(spec)
    jp = jparams
    if dtype == "bf16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.dtype == jnp.float32 and a.ndim > 1 else a,
                          jparams)
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16
                              if dtype == "bf16" else torch.float32)
    params = from_jax_params(_np(jp), cfg, "cpu")
    placed = jax.device_put(jp, jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh))
    shards = shard_params(params, mesh)
    assert len(shards) == mesh.devices.size
    mine = [dict(_leaves(s)) for s in shards]
    for name, arr in _leaves(placed):
        by_dev = {s.device: s.data for s in arr.addressable_shards}
        for i, dev in enumerate(jmesh.devices.flat):
            got = mine[i][name]
            assert got.is_contiguous()
            np.testing.assert_array_equal(_bits(got), _np_bits(by_dev[dev]))
    back = dict(_leaves(gather_params(shards, mesh)))
    for name, t in _leaves(params):
        np.testing.assert_array_equal(_bits(back[name]), _bits(t))


def test_shard_batch_matches_jax():
    """Each position's batch slice is the shard JAX places on its device;
    a 0-d value is replicated."""
    jmesh, mesh = _meshes(MESH)
    batch = {"tokens": _tokens((8, 9), 3), "scale": np.float32(0.5)}
    placed = jax_shard_batch(jax.tree.map(jnp.asarray, batch), jmesh)
    mine = shard_batch(batch, mesh)
    assert len(mine) == 8
    for name, arr in placed.items():
        by_dev = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for i, dev in enumerate(jmesh.devices.flat):
            np.testing.assert_array_equal(mine[i][name].numpy(), by_dev[dev])
    # Positions of one batch group share one tensor on one device.
    assert mine[0]["tokens"] is mine[1]["tokens"]
    assert mine[0]["tokens"].shape == (2, 9)


def _gathered_state(ts, mesh):
    return {"params": gather_params(ts["params"], mesh),
            "opt_state": {**ts["opt_state"],
                          "mu": gather_params(ts["opt_state"]["mu"], mesh),
                          "nu": gather_params(ts["opt_state"]["nu"], mesh)},
            "step": ts["step"]}


def test_three_sharded_steps_match_jax(jax_bundle):
    """Three steps of the sharded make_train_step from a JAX state carried
    across, against JAX's make_train_step on the same 2x2x2 mesh: loss and
    grad norm each step, the params unchanged by step 1 (learning rate 0),
    the gathered params, mu and nu after."""
    _, mesh = _meshes(MESH)
    js = jax_bundle.init(jax.random.key(0))
    ts = from_jax_state(_np(js), CFG, "cpu", mesh=mesh)
    before = [t.clone() for _, t in _leaves(gather_params(ts["params"],
                                                            mesh))]
    tb = make_train_step(CFG, mesh, optimizer=_optimizer(False),
                         device="cpu")
    assert tb.mesh is mesh and tb.rules is not None
    batch = {"tokens": _tokens((8, 33), 0)}
    for i in range(STEPS):
        js, jm = jax_bundle.step(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tb.step(ts, jax.tree.map(torch.from_numpy, batch))
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-3)
        assert tm["step"] == int(jm["step"]) == i + 1
        if i == 0:
            after = [t for _, t in _leaves(gather_params(ts["params"],
                                                         mesh))]
            assert all(torch.equal(a, b) for a, b in zip(after, before))
    _check_state(_gathered_state(ts, mesh), _np(js), lr_steps=STEPS - 1)


def test_from_jax_state_on_a_mesh_is_bit_exact_both_ways(jax_bundle):
    """A JAX state two steps in, carried into the sharded layout and
    gathered back, bit for bit; each shard equals the JAX state's
    addressable shard on that position's device."""
    jmesh, mesh = _meshes(MESH)
    js = jax_bundle.init(jax.random.key(1))
    batch = {"tokens": jnp.asarray(_tokens((8, 33), 4))}
    for _ in range(2):
        js, _ = jax_bundle.step(js, batch)
    ts = from_jax_state(_np(js), CFG, "cpu", mesh=mesh)
    adam = js["opt_state"][1][0]
    for mine, theirs in ((ts["params"], js["params"]),
                         (ts["opt_state"]["mu"], adam.mu),
                         (ts["opt_state"]["nu"], adam.nu)):
        back = dict(_leaves(gather_params(mine, mesh)))
        per_pos = [dict(_leaves(t)) for t in mine]
        for name, arr in _leaves(theirs):
            np.testing.assert_array_equal(back[name].numpy(),
                                          np.asarray(arr))
            by_dev = {s.device: np.asarray(s.data)
                      for s in arr.addressable_shards}
            for i, dev in enumerate(jmesh.devices.flat):
                np.testing.assert_array_equal(per_pos[i][name].numpy(),
                                              by_dev[dev])
    assert ts["step"] == 2 and ts["opt_state"]["count"] == 2


def test_sharded_step_matches_the_unsharded_port_step(jparams):
    """The sharded port step against the unsharded port step on the same
    state, three steps: metrics, and the sharded value_and_grad's grads
    gathered against the unsharded grads."""
    _, mesh = _meshes(MESH)
    batch = {"tokens": torch.from_numpy(_tokens((8, 33), 6))}
    init = _np(jparams)
    flat = make_train_step(CFG, optimizer=_optimizer(False), device="cpu")
    sharded = make_train_step(CFG, mesh, optimizer=_optimizer(False),
                              device="cpu")
    fs = flat.init()
    fs["params"] = from_jax_params(init, CFG, "cpu")
    fs["opt_state"] = flat.optimizer.init(fs["params"])
    params = shard_params(from_jax_params(init, CFG, "cpu"), mesh)
    ss = {"params": params, "opt_state": sharded.optimizer.init(params),
          "step": 0}
    loss, grads = value_and_grad(fs["params"], batch, CFG, device="cpu")
    sloss, sgrads = value_and_grad(ss["params"], batch, CFG, device="cpu",
                                   mesh=mesh)
    np.testing.assert_allclose(float(sloss), float(loss), rtol=1e-5)
    specs = tree_specs(jax_param_logical_axes(JCFG), mesh)
    for li in range(CFG.num_layers):
        for group in ("attn", "mlp"):
            for name, g in grads["layers"][li][group].items():
                parts = [t["layers"][li][group][name] for t in sgrads]
                spec = specs["layers"][group][name][1:]
                np.testing.assert_allclose(
                    gather_tensor(parts, spec, mesh).numpy(), g.numpy(),
                    rtol=1e-4, atol=1e-6, err_msg=f"{li}.{name}")
    for name in ("embed", "lm_head", "ln_f"):
        np.testing.assert_allclose(
            gather_tensor([t[name] for t in sgrads], specs[name],
                          mesh).numpy(), grads[name].numpy(),
            rtol=1e-4, atol=1e-6, err_msg=name)
    for _ in range(STEPS):
        fs, fm = flat.step(fs, batch)
        ss, sm = sharded.step(ss, batch)
        np.testing.assert_allclose(sm["loss"], fm["loss"], rtol=1e-5)
        np.testing.assert_allclose(sm["grad_norm"], fm["grad_norm"],
                                   rtol=1e-4)
    # The bounds of the unsharded trajectory's test: Adam may normalise a
    # gradient element that is f32 noise to another step.
    _assert_params_close(gather_params(ss["params"], mesh),
                         jax.tree.map(lambda t: t.numpy(), fs["params"]),
                         lr_steps=STEPS - 1)


def test_eval_step_under_a_mesh_matches_jax(jparams):
    jmesh, mesh = _meshes(MESH)
    placed = jax.device_put(jparams, jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh))
    toks = _tokens((8, 19), 5)
    want = float(jax_make_eval_step(JCFG, jmesh)(
        placed, {"tokens": jnp.asarray(toks)}))
    shards = shard_params(from_jax_params(_np(jparams), CFG, "cpu"), mesh)
    got = make_eval_step(CFG, mesh, device="cpu")(
        shards, {"tokens": torch.from_numpy(toks)})
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), want, **TOL)


def test_each_shard_is_held_once_per_distinct_device():
    """On a mesh that names the CPU 8 times the state's distinct tensors
    hold exactly the unsharded bytes: a slice shared by dp replicas, and a
    tensor no rule splits, is one tensor (the params' own where it is not
    split at all); mu and nu keep the sharing."""
    _, mesh = _meshes(MESH)
    tb = make_train_step(CFG, mesh, optimizer=_optimizer(False),
                         device="cpu")
    state = tb.init(torch.Generator().manual_seed(0))
    full = gather_params(state["params"], mesh)
    whole = sum(t.nbytes for _, t in _leaves(full))
    for tree in (state["params"], state["opt_state"]["mu"],
                 state["opt_state"]["nu"]):
        distinct = {id(t): t for s in tree for _, t in _leaves(s)}
        assert sum(t.nbytes for t in distinct.values()) == whole
        assert len({t.data_ptr() for t in distinct.values()}) == len(distinct)
        # dp replicas share: position (0, f, t) and (1, f, t) hold one
        # tensor for every leaf.
        for i in range(4):
            for (_, a), (_, b) in zip(_leaves(tree[i]), _leaves(tree[i + 4])):
                assert a is b
    params = from_jax_params(_np(jax_init_params(JCFG, jax.random.key(0))),
                             CFG, "cpu")
    shards = shard_params(params, mesh)
    for s in shards:                   # not split by any rule: no copy
        assert s["ln_f"] is params["ln_f"]
        assert s["layers"]["ln_attn"] is params["layers"]["ln_attn"]
    assert tb.state_specs["params"] == tree_specs(
        jax_param_logical_axes(JCFG), mesh)
    assert tb.state_specs["opt_state"]["mu"] == tb.state_specs["params"]
    assert tb.state_specs["step"] == ()


def test_megatron_rules_give_the_same_loss_and_other_tables_raise(jparams):
    _, mesh = _meshes(MESH)
    params = from_jax_params(_np(jparams), CFG, "cpu")
    batch = {"tokens": torch.from_numpy(_tokens((8, 17), 7))}
    with torch.no_grad():
        want = float(loss_fn(params, batch, CFG, device="cpu"))
        default = float(loss_fn(params, batch, CFG, mesh, device="cpu"))
        megatron = float(loss_fn(params, batch, CFG, mesh, device="cpu",
                                 rules=megatron_rules()))
    np.testing.assert_allclose([default, megatron], [want, want], rtol=1e-5)
    tb = make_train_step(CFG, mesh, optimizer=_optimizer(False),
                         rules=megatron_rules(), device="cpu")
    state = tb.init(torch.Generator().manual_seed(0))
    assert state["params"][0]["embed"] is state["params"][7]["embed"]
    _, m = tb.step(state, batch)
    assert np.isfinite(m["loss"]) and m["step"] == 1
    # Another table, once refused, stores the MLP's weights as it says
    # (their hidden units whole, the embed dim over fsdp) and gives the
    # same loss, and its train step the loss and grad norm of the
    # default table's (the parity of every table with JAX is in
    # tests/test_torch_axis_rules.py).
    other = LogicalAxisRules.default().with_overrides(("mlp", "fsdp"))
    with torch.no_grad():
        got = float(loss_fn(params, batch, CFG, mesh, device="cpu",
                            rules=other))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jmesh, _ = _meshes(MESH)
    jother = JaxRules.default().with_overrides(("mlp", "fsdp"))
    jbatch = jax.tree.map(jnp.asarray, {"tokens": _tokens((8, 17), 7)})
    placed = jax.device_put(jparams, jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh, jother))
    np.testing.assert_allclose(got, float(jax.jit(lambda p, b: jax_loss_fn(
        p, b, JCFG, jmesh, jother))(placed, jbatch)), **TOL)
    tb_other = make_train_step(CFG, mesh, optimizer=_optimizer(False),
                               rules=other, device="cpu")
    assert tb_other.state_specs["params"]["layers"]["mlp"]["w_up"] == (
        "pp", "fsdp")
    tb = make_train_step(CFG, mesh, optimizer=_optimizer(False),
                         device="cpu")
    metrics = []
    for bundle in (tb, tb_other):
        params = from_jax_params(_np(jparams), CFG, "cpu")
        state = {"params": shard_params(params, mesh, bundle.rules),
                 "step": 0}
        state["opt_state"] = bundle.optimizer.init(state["params"])
        metrics.append(bundle.step(state, batch)[1])
    np.testing.assert_allclose(metrics[1]["loss"], metrics[0]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(metrics[1]["grad_norm"],
                               metrics[0]["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("spec", [dict(pp=2, sp=2), dict(sp=2, tp=2),
                                  dict(dp=2, sp=2), dict(fsdp=2, sp=4)])
def test_unported_layouts_raise_naming_their_roadmap_item(jparams, spec):
    """sp beside another split axis, once unported, now trains: loss_fn,
    make_eval_step and one make_train_step step on the mesh against the
    unsharded port (the parity with JAX is in
    tests/test_torch_train_sp.py)."""
    mesh = build_mesh(MeshSpec(**spec),
                      devices=[CPU] * MeshSpec(**spec).n_devices)
    params = from_jax_params(_np(jparams), CFG, "cpu")
    batch = {"tokens": torch.from_numpy(_tokens((8, 9), 8))}
    with torch.no_grad():
        want = float(loss_fn(params, batch, CFG, device="cpu"))
        got = float(loss_fn(params, batch, CFG, mesh, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        float(make_eval_step(CFG, mesh, device="cpu")(params, batch)), want,
        rtol=1e-5)
    tb = make_train_step(CFG, mesh, optimizer=_optimizer(False),
                         device="cpu")
    shards = shard_params(from_jax_params(_np(jparams), CFG, "cpu"), mesh)
    _, m = tb.step({"params": shards,
                    "opt_state": tb.optimizer.init(shards), "step": 0},
                   batch)
    np.testing.assert_allclose(m["loss"], want, rtol=1e-5)
    # Without a pp axis num_microbatches is ignored, as in the JAX package.
    tb = make_train_step(CFG, _meshes(MESH)[1], num_microbatches=2,
                         device="cpu")
    assert tb.state_specs["params"]["layers"]["attn"]["wq"][0] == "pp"


def test_sp_alone_trains_as_the_unsharded_step(jparams):
    """sp alone is a training layout too: ring attention over its
    positions, the params replicated; its step equals the unsharded one."""
    cfg = dataclasses.replace(CFG, attention_impl="ring")
    mesh = build_mesh(MeshSpec(sp=2), devices=[CPU] * 2)
    init = _np(jparams)
    batch = {"tokens": torch.from_numpy(_tokens((2, 33), 9))}
    flat = make_train_step(CFG, optimizer=_optimizer(False), device="cpu")
    ring = make_train_step(cfg, mesh, optimizer=_optimizer(False),
                           device="cpu")
    fs = {"params": from_jax_params(init, CFG, "cpu"), "step": 0}
    fs["opt_state"] = flat.optimizer.init(fs["params"])
    params = shard_params(from_jax_params(init, CFG, "cpu"), mesh)
    assert params[0]["embed"] is params[1]["embed"]
    rs = {"params": params, "opt_state": ring.optimizer.init(params),
          "step": 0}
    for _ in range(2):
        fs, fm = flat.step(fs, batch)
        rs, rm = ring.step(rs, batch)
        np.testing.assert_allclose(rm["loss"], fm["loss"], rtol=2e-3)
        np.testing.assert_allclose(rm["grad_norm"], fm["grad_norm"],
                                   rtol=2e-3)
