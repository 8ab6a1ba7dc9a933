"""The expert-parallel MoE layer on meshes over several processes (gloo
ranks on the CPU) against the JAX package's.

Each mesh spans a gloo world of spawned processes formed by the port's
Train backend: fsdp=2 x sp=2 x tp=2 over two ranks (two expert groups and
both MLP slices a rank) and over four (one expert group a rank, both
slices), and fsdp=2 x sp=2 and fsdp=2 x tp=2 over four (the layouts the
card runs). Every rank holds only its positions' shards of JAX's params
(``shard_params``, default rules: experts over fsdp x sp, MLP units over
tp, the router's embed dim over fsdp), passes the whole x and gets y of
its run of the tokens (``moe_rows``). Its objective is the sum of its y,
plus the two aux losses on rank 0, so the ranks' objectives sum to the
one that ``tests/test_torch_moe.py`` differentiates. The parent runs
JAX's ``moe_layer`` on the same ``MeshSpec`` of the conftest's CPU
devices with its params placed by the default rules. f32 throughout: the
routing exact (against the JAX routing recomputed as
``tests/test_torch_moe.py`` does), y, the aux losses and every gathered
parameter gradient within 1e-4.

The spawned ranks import this module, so it imports JAX and the JAX
package only inside fixtures.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import (MoEConfig, moe_logical_axes,
                                  moe_params_from_jax)
from ray_tpu_torch.models.moe import moe_layer_routed, moe_rows
from ray_tpu_torch.parallel import (LogicalAxisRules, MeshSpec, build_mesh,
                                    shard_params, tree_specs)
from ray_tpu_torch.parallel.sharding import gather_tensor
from test_torch_collective import spawn_ranks

TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(d_model=16, d_ff=32, num_experts=4)
B, S = 4, 8
AUX = ("moe_load_balance_loss", "moe_router_z_loss", "moe_fraction_dropped")
# name: (mesh, world, capacity factor)
RUNS = {"fsdp2xsp2xtp2-2ranks": (dict(fsdp=2, sp=2, tp=2), 2, 1.25),
        "fsdp2xsp2xtp2": (dict(fsdp=2, sp=2, tp=2), 4, 1.25),
        "fsdp2xsp2": (dict(fsdp=2, sp=2), 4, 1.25),
        # Capacity below the demand: choices are dropped.
        "fsdp2xtp2-dropping": (dict(fsdp=2, tp=2), 4, 0.5)}
NAMES = list(RUNS)


def _cfg(name):
    return MoEConfig(dtype=torch.float32, capacity_factor=RUNS[name][2],
                     **KW)


def _ranks(rank, world, jobs):
    """Each job (name, JAX params as numpy, x): this rank's rows, y,
    aux, routing and its positions' parameter gradients."""
    out = {}
    for name, np_params, x in jobs:
        mesh = build_mesh(MeshSpec(**RUNS[name][0]))
        cfg = _cfg(name)
        shards = shard_params(moe_params_from_jax(np_params, "cpu"), mesh,
                              logical_axes=moe_logical_axes())
        leaves = {}
        sl = [None if t is None else {
            k: leaves.setdefault(id(v), v.detach().requires_grad_())
            for k, v in t.items()} for t in shards]
        y, aux, (idx, keep) = moe_layer_routed(sl, torch.from_numpy(x), cfg,
                                               mesh=mesh)
        objective = y.sum()
        if rank == 0:
            objective = objective + aux[AUX[0]] + aux[AUX[1]]
        objective.backward()
        out[name] = dict(
            rows=moe_rows(mesh, B * S), y=y.detach().numpy(),
            aux={k: float(v.detach()) for k, v in aux.items()},
            idx=idx.numpy(), keep=keep.numpy(),
            grads={i: {k: (torch.zeros_like(v) if v.grad is None
                           else v.grad).numpy() for k, v in sl[i].items()}
                   for i in mesh.local_positions()})
    return out


def _jax_routing(jp, x, jcfg):
    from test_torch_moe import _jax_routing as routing
    return routing(jp, x, jcfg)


@pytest.fixture(scope="module")
def jax_side():
    """{name: (params, x, y, aux, grads, (idx, keep))} from JAX's
    moe_layer on each mesh of the conftest's CPU devices."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.moe import MoEConfig as JaxMoEConfig
    from ray_tpu.models.moe import init_moe_params, moe_layer
    from ray_tpu.models.moe import moe_logical_axes as jax_axes
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    from ray_tpu.parallel.sharding import tree_shardings
    out = {}
    for name, (spec, _, cf) in RUNS.items():
        jcfg = JaxMoEConfig(dtype=jnp.float32, capacity_factor=cf, **KW)
        jp = init_moe_params(jcfg, jax.random.key(0))
        x = np.array(jax.random.normal(jax.random.key(1),
                                       (B, S, jcfg.d_model)))
        jmesh = jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[
            :MeshSpec(**spec).n_devices])
        placed = jax.device_put(jp, tree_shardings(jax_axes(), jmesh))

        def objective(p, jcfg=jcfg, x=x):
            y, aux = moe_layer(p, x, jcfg)
            return y.sum() + aux[AUX[0]] + aux[AUX[1]], (y, aux)
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            objective, has_aux=True))(placed)
        np_params = jax.tree.map(np.asarray, jp)
        out[name] = (np_params, x, np.asarray(y),
                     {k: float(v) for k, v in aux.items()},
                     jax.tree.map(np.asarray, grads),
                     _jax_routing(jp, x, jcfg))
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """{world: every rank's results}, one spawn per world."""
    out = {}
    for world in sorted({w for _, w, _ in RUNS.values()}):
        jobs = [(n, *jax_side[n][:2]) for n in NAMES if RUNS[n][1] == world]
        out[world] = spawn_ranks(_ranks, world,
                                 tmp_path_factory.mktemp(f"world{world}"),
                                 jobs)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_routing_is_exact_on_every_rank(name, ranks, jax_side):
    idx, keep = jax_side[name][5]
    for got in ranks[RUNS[name][1]]:
        np.testing.assert_array_equal(got[name]["idx"], idx)
        np.testing.assert_array_equal(got[name]["keep"], keep)
    if RUNS[name][2] < 1:
        assert not keep.all()


@pytest.mark.parametrize("name", NAMES)
def test_rank_rows_and_aux_match_jax(name, ranks, jax_side):
    """The ranks' runs tile the tokens in rank order; each run's y and
    every rank's aux losses are JAX's."""
    _, _, y, aux, _, _ = jax_side[name]
    want = y.reshape(B * S, -1)
    got = [r[name] for r in ranks[RUNS[name][1]]]
    assert [g["rows"] for g in got] == [
        (r * B * S // len(got), (r + 1) * B * S // len(got))
        for r in range(len(got))]
    for g in got:
        a, b = g["rows"]
        np.testing.assert_allclose(g["y"], want[a:b], **TOL)
        for k in AUX:
            np.testing.assert_allclose(g["aux"][k], aux[k], **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_gathered_gradients_match_jax(name, ranks, jax_side):
    """Every parameter's gradient, gathered over the positions from the
    ranks that hold them (each slice from its first holder), is
    ``jax.grad``'s."""
    spec, world, _ = RUNS[name]
    grads = jax_side[name][4]
    n = MeshSpec(**spec).n_devices
    mesh = build_mesh(MeshSpec(**spec), devices=["cpu"] * n)
    per = {}
    for got in ranks[world]:
        per.update(got[name]["grads"])
    specs = tree_specs(moe_logical_axes(), mesh, LogicalAxisRules.default())
    for k, want in grads.items():
        full = gather_tensor([torch.from_numpy(per[i][k]) for i in range(n)],
                             specs[k], mesh)
        np.testing.assert_allclose(full.numpy(), want, err_msg=k, **TOL)
