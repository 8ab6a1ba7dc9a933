"""Parity of ray_tpu_torch's ring attention and Ulysses with the JAX
package's on the CPU (the ports of tests/test_ops.py:51-100).

The same numpy inputs go through JAX's ``shard_map`` programs on the
conftest's 8 CPU devices (a dp=2 x sp=4 mesh, as in tests/test_ops.py; dp
splits the batch and changes no value) and through the port on a mesh that
names the CPU four times (the port splits only the sequence). f32
throughout: 1e-4 for the ops, 2e-3 for the model's logits.
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
from ray_tpu.ops import ring_attention as jax_ring_attention
from ray_tpu.ops import ulysses_attention as jax_ulysses_attention
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu_torch.models import PRESETS, forward, from_jax_params, loss_fn
from ray_tpu_torch.models.transformer import _attention
from ray_tpu_torch.ops.flash_attention import reference_attention
from ray_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention
from ray_tpu_torch.parallel import MeshSpec, build_mesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_qkv(B=2, S=32, Hq=4, Hkv=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Hq, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def _sp_mesh(n):
    return build_mesh(MeshSpec(sp=n), devices=[CPU] * n)


def _both(np_qkv, port_fn, jax_fn, jax_mesh, port_mesh, **kw):
    want = np.asarray(jax_fn(*map(jnp.asarray, np_qkv), mesh=jax_mesh, **kw))
    got = port_fn(*map(torch.from_numpy, np_qkv), port_mesh, **kw)
    return got.numpy(), want


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_and_reference(causal):
    qkv = _rand_qkv(B=2, S=32, Hq=4, Hkv=2, D=16)
    got, want = _both(qkv, ring_attention, jax_ring_attention,
                      jax_build_mesh(JaxMeshSpec(dp=2, sp=4)), _sp_mesh(4),
                      causal=causal)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    ref = reference_attention(*map(torch.from_numpy, qkv), causal=causal)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_ring_at_other_degrees_matches_reference(n):
    """sp=1 is the degenerate one-shard pass; 8 shards of 4 tokens each
    put most blocks wholly after their queries."""
    qkv = _rand_qkv(B=2, S=32, Hq=4, Hkv=2, D=16, seed=n)
    got, want = _both(qkv, ring_attention, jax_ring_attention,
                      jax_build_mesh(JaxMeshSpec(sp=n),
                                     devices=jax.devices()[:n]),
                      _sp_mesh(n), causal=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ring_sp1_degenerates():
    qkv = _rand_qkv(B=8)
    got, want = _both(qkv, ring_attention, jax_ring_attention,
                      jax_build_mesh(JaxMeshSpec(dp=8)),
                      build_mesh(MeshSpec(), devices=[CPU]), causal=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    ref = reference_attention(*map(torch.from_numpy, qkv), causal=True)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax_and_reference(causal):
    # heads divisible by sp: Hq=Hkv=4; and GQA with Hq=8, Hkv=4.
    for hq in (4, 8):
        qkv = _rand_qkv(B=2, S=32, Hq=hq, Hkv=4, D=16, seed=hq)
        got, want = _both(qkv, ulysses_attention, jax_ulysses_attention,
                          jax_build_mesh(JaxMeshSpec(dp=2, sp=4)),
                          _sp_mesh(4), causal=causal)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ulysses_needs_heads_divisible_by_sp():
    q, k, v = map(torch.from_numpy, _rand_qkv(Hq=4, Hkv=2))
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, k, v, _sp_mesh(4))


@pytest.mark.parametrize("spec", [dict(dp=2, sp=4), dict(sp=2, tp=2),
                                  dict(dp=8)])
def test_non_sp_meshes_raise_not_implemented(spec):
    q, k, v = map(torch.from_numpy, _rand_qkv())
    mesh = build_mesh(MeshSpec(**spec),
                      devices=[CPU] * MeshSpec(**spec).n_devices)
    for fn in (ring_attention, ulysses_attention):
        with pytest.raises(NotImplementedError, match="item 4"):
            fn(q, k, v, mesh)


def test_a_sequence_that_does_not_split_raises():
    q, k, v = map(torch.from_numpy, _rand_qkv(S=30))
    with pytest.raises(ValueError, match="does not split"):
        ring_attention(q, k, v, _sp_mesh(4))


@pytest.fixture(scope="module")
def tiny():
    jp = jax_init_params(JAX_PRESETS["tiny"], jax.random.key(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp),
                               PRESETS["tiny"], "cpu")


def test_ring_attention_in_model(tiny):
    """attention_impl='ring' end to end: the port's forward on an sp=4 mesh
    against JAX's under jit on a dp x sp mesh, and against the port's
    forward with plain attention."""
    jp, tp = tiny
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], attention_impl="ring")
    cfg = dataclasses.replace(PRESETS["tiny"], attention_impl="ring")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (4, 32))
    jmesh = jax_build_mesh(JaxMeshSpec(dp=2, sp=4))
    with jax.sharding.use_mesh(jmesh) if hasattr(jax.sharding, "use_mesh") \
            else jmesh:
        want = jax.jit(lambda p, t: jax_forward(p, t, jcfg, jmesh))(
            jp, jnp.asarray(toks, jnp.int32))
    got = forward(tp, torch.from_numpy(toks), cfg, _sp_mesh(4),
                  device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-3)
    plain = forward(tp, torch.from_numpy(toks),
                    dataclasses.replace(cfg, attention_impl="xla"),
                    device="cpu")
    np.testing.assert_allclose(got.numpy(), plain.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_ring_without_a_mesh_is_plain_attention():
    q, k, v = map(torch.from_numpy, _rand_qkv())
    cfg = dataclasses.replace(PRESETS["tiny"], attention_impl="ring")
    torch.testing.assert_close(_attention(cfg, q, k, v),
                               reference_attention(q, k, v, causal=True),
                               rtol=0, atol=0)


def test_gradient_through_the_ring_matches_plain_attention():
    """Autograd runs back through the ring's plain ops and its rotations:
    dq, dk, dv against autograd through plain attention."""
    grads = []
    for attend in (lambda q, k, v: ring_attention(q, k, v, _sp_mesh(4)),
                   lambda q, k, v: reference_attention(q, k, v, causal=True)):
        q, k, v = (torch.from_numpy(a).requires_grad_()
                   for a in _rand_qkv(B=1, S=32, Hq=4, Hkv=2, D=16, seed=7))
        (attend(q, k, v) ** 2).sum().backward()
        grads.append((q.grad, k.grad, v.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_loss_gradient_with_ring_matches_jax(tiny):
    """loss_fn's gradient with attention_impl='ring' on an sp=2 mesh (remat
    on: the checkpointed layers recompute through the ring) against JAX's
    on an sp=2 mesh."""
    jp, tp = tiny
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], attention_impl="ring")
    cfg = dataclasses.replace(PRESETS["tiny"], attention_impl="ring")
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 33))
    jmesh = jax_build_mesh(JaxMeshSpec(sp=2), devices=jax.devices()[:2])
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, {"tokens": jnp.asarray(toks, jnp.int32)},
                              jcfg, jmesh)))(jp)
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in tp["layers"]["attn"].items()}
    params = dict(tp, layers=dict(tp["layers"], attn=leaves))
    loss = loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg,
                   _sp_mesh(2), device="cpu")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name, leaf in leaves.items():
        np.testing.assert_allclose(
            leaf.grad.numpy(), np.asarray(jgrad["layers"]["attn"][name]),
            rtol=1e-3, atol=1e-5, err_msg=name)
