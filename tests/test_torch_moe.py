"""Parity of ray_tpu_torch's Mixture-of-Experts layer (``models/moe.py``)
with the JAX package's on the CPU.

The ports of ``tests/test_parallel_advanced.py``'s MoE tests. JAX's params
(``init_moe_params``, f32) and inputs are carried across as numpy; both
layers run in f32 (``dtype=float32``), so y, the aux losses and the
gradients agree within 1e-4 and the routing exactly. Expert parallelism:
JAX on fsdp=2 x sp=2 x tp=2 of the conftest's virtual CPU devices with its
params placed by the default rules, the port on a mesh that names the CPU
8 times.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.moe import MoEConfig as JaxMoEConfig
from ray_tpu.models.moe import init_moe_params as jax_init_moe_params
from ray_tpu.models.moe import moe_layer as jax_moe_layer
from ray_tpu.models.moe import moe_logical_axes as jax_moe_logical_axes
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu.parallel.sharding import tree_shardings as jax_tree_shardings
from ray_tpu_torch.models import (MoEConfig, init_moe_params, moe_layer,
                                  moe_logical_axes, moe_params_from_jax)
from ray_tpu_torch.models.moe import moe_layer_routed
from ray_tpu_torch.parallel import (LogicalAxisRules, MeshSpec, build_mesh,
                                    shard_params, tree_specs)
from ray_tpu_torch.parallel.sharding import gather_tensor

TOL = dict(rtol=1e-4, atol=1e-4)
EP_MESH = dict(fsdp=2, sp=2, tp=2)
AUX = ("moe_load_balance_loss", "moe_router_z_loss", "moe_fraction_dropped")


def _cfgs(**kw):
    return (JaxMoEConfig(dtype=jnp.float32, **kw),
            MoEConfig(dtype=torch.float32, **kw))


def _setup(B=2, S=8, **kw):
    jcfg, cfg = _cfgs(**kw)
    jp = jax_init_moe_params(jcfg, jax.random.key(0))
    x = np.array(jax.random.normal(jax.random.key(1),
                                   (B, S, jcfg.d_model)))
    return jcfg, cfg, jp, moe_params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu"), x


def _jax_routing(jp, x, jcfg):
    """JAX's expert_idx and keep, recomputed as moe.py:75-90 does."""
    N = x.shape[0] * x.shape[1]
    E, K = jcfg.num_experts, jcfg.num_experts_per_token
    C = max(1, int(jcfg.capacity_factor * N * K / E))
    logits = x.reshape(N, -1).astype(np.float32) @ np.asarray(jp["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), K)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(N * K, E)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    return np.asarray(idx), np.asarray(
        ((pos * onehot).sum(-1).reshape(N, K)) < C)


def test_moe_layer_shapes_and_losses():
    _, cfg, _, params, x = _setup(d_model=16, d_ff=32, num_experts=4)
    y, aux = moe_layer(params, torch.from_numpy(x), cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert float(aux["moe_load_balance_loss"]) > 0
    assert float(aux["moe_router_z_loss"]) >= 0
    assert 0.0 <= float(aux["moe_fraction_dropped"]) <= 1.0
    # The port's own init: f32, the JAX layouts.
    own = init_moe_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        "router": ((16, 4), torch.float32),
        "w_gate": ((4, 16, 32), torch.float32),
        "w_up": ((4, 16, 32), torch.float32),
        "w_down": ((4, 32, 16), torch.float32)}
    assert moe_logical_axes() == jax_moe_logical_axes()


def test_moe_single_expert_matches_dense_ffn():
    """E=1, K=1, ample capacity: MoE equals the plain silu-gated FFN."""
    _, cfg, _, params, x = _setup(B=2, S=4, d_model=8, d_ff=16,
                                  num_experts=1, num_experts_per_token=1,
                                  capacity_factor=2.0)
    xt = torch.from_numpy(x)
    y, aux = moe_layer(params, xt, cfg)
    assert float(aux["moe_fraction_dropped"]) == 0.0
    xf = xt.reshape(-1, 8)
    g, u = xf @ params["w_gate"][0], xf @ params["w_up"][0]
    dense = ((torch.nn.functional.silu(g) * u) @ params["w_down"][0])
    np.testing.assert_allclose(y.numpy(), dense.reshape(x.shape).numpy(),
                               **TOL)


@pytest.mark.parametrize("kw", [
    dict(d_model=16, d_ff=32, num_experts=4),
    # Capacity below the demand: choices are dropped.
    dict(d_model=16, d_ff=32, num_experts=4, capacity_factor=0.5),
    dict(d_model=32, d_ff=48, num_experts=8, num_experts_per_token=2)])
def test_moe_layer_matches_jax(kw):
    """y, every aux value and the routing against JAX's moe_layer on the
    same params and x."""
    jcfg, cfg, jp, params, x = _setup(B=2, S=16, **kw)
    jy, jaux = jax.jit(lambda p, x: jax_moe_layer(p, x, jcfg))(jp, x)
    y, aux, (idx, keep) = moe_layer_routed(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in AUX:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **TOL)
    want_idx, want_keep = _jax_routing(jp, x, jcfg)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if kw.get("capacity_factor") == 0.5:
        assert float(aux["moe_fraction_dropped"]) > 0


def _objective(y, aux):
    return y.sum() + sum(aux[k] for k in AUX[:2])


def test_moe_gradients_match_jax():
    """Every parameter's gradient of sum(y) + the two aux losses against
    jax.grad's."""
    jcfg, cfg, jp, params, x = _setup(B=2, S=16, d_model=16, d_ff=32,
                                      num_experts=4)

    def jloss(p):
        y, aux = jax_moe_layer(p, x, jcfg)
        return _objective(y, aux)
    want = jax.jit(jax.grad(jloss))(jp)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    y, aux = moe_layer(leaves, torch.from_numpy(x), cfg)
    _objective(y, aux).backward()
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_moe_sharded_over_ep_axes_matches_unsharded_and_jax():
    """Experts over fsdp x sp, MLP units over tp, the router's embed dim
    over fsdp: the ep-sharded layer's y, aux and routing equal the
    unsharded layer's (routing bit for bit) and JAX's sharded run; its
    gathered gradients equal the unsharded ones."""
    jcfg, cfg, jp, params, x = _setup(B=4, S=8, d_model=16, d_ff=32,
                                      num_experts=4)
    n = MeshSpec(**EP_MESH).n_devices
    jmesh = jax_build_mesh(JaxMeshSpec(**EP_MESH), devices=jax.devices()[:n])
    placed = jax.device_put(jp, jax_tree_shardings(jax_moe_logical_axes(),
                                                   jmesh))
    jy, jaux = jax.jit(lambda p, x: jax_moe_layer(p, x, jcfg))(placed, x)
    mesh = build_mesh(MeshSpec(**EP_MESH), devices=["cpu"] * n)
    shards = shard_params(params, mesh, logical_axes=moe_logical_axes())
    assert tuple(shards[0]["w_gate"].shape) == (1, 16, 16)
    assert tuple(shards[0]["w_down"].shape) == (1, 16, 16)
    assert tuple(shards[0]["router"].shape) == (8, 4)
    # Each shard is JAX's addressable shard on that position's device.
    for name, arr in placed.items():
        by_dev = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for i, dev in enumerate(jmesh.devices.flat):
            np.testing.assert_array_equal(shards[i][name].numpy(),
                                          by_dev[dev])
    xt = torch.from_numpy(x)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    y0, aux0, (idx0, keep0) = moe_layer_routed(leaves, xt, cfg)
    _objective(y0, aux0).backward()
    sl = [{k: v.detach().requires_grad_() for k, v in s.items()}
          for s in shards]
    # Positions that share a slice on one device share its leaf.
    by_id = {}
    sl = [{k: by_id.setdefault(id(s[k]), v) for k, v in t.items()}
          for s, t in zip(shards, sl)]
    y, aux, (idx, keep) = moe_layer_routed(sl, xt, cfg, mesh=mesh)
    assert torch.equal(idx, idx0) and torch.equal(keep, keep0)
    np.testing.assert_allclose(y.detach().numpy(), y0.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    for k in AUX:
        got = float(aux[k].detach())
        np.testing.assert_allclose(got, float(jaux[k]), **TOL)
        np.testing.assert_allclose(got, float(aux0[k].detach()), **TOL)
    _objective(y, aux).backward()
    specs = tree_specs(moe_logical_axes(), mesh, LogicalAxisRules.default())
    for k, v in leaves.items():
        got = gather_tensor([t[k].grad if t[k].grad is not None
                             else torch.zeros_like(t[k]) for t in sl],
                            specs[k], mesh)
        np.testing.assert_allclose(got.numpy(), v.grad.numpy(),
                                   err_msg=k, **TOL)
    # The full tree is split on the way in, with the same values.
    y2, _ = moe_layer(params, xt, cfg, mesh=mesh)
    np.testing.assert_allclose(y2.detach().numpy(), y.detach().numpy(),
                               rtol=0, atol=0)
