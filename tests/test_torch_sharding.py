"""Parity of ray_tpu_torch's logical-axis rules and tensor-parallel split
with the JAX package's ``parallel/sharding.py`` on the CPU.

``LogicalAxisRules`` is a copy: every spec must equal JAX's as a tuple.
``shard_params`` must give each tp position exactly the slice that
``jax.device_put(params, tree_shardings(...))`` places on the mesh's device
of that position (the conftest's CPU devices): bit-equal, f32 and bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu.models.transformer import \
    param_logical_axes as jax_param_logical_axes
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu.parallel.sharding import LogicalAxisRules as JaxRules
from ray_tpu.parallel.sharding import replicated as jax_replicated
from ray_tpu.parallel.sharding import tree_shardings as jax_tree_shardings
from ray_tpu_torch.models import PRESETS, from_jax_params
from ray_tpu_torch.models.transformer import (megatron_rules,
                                              param_logical_axes, tp_shards)
from ray_tpu_torch.parallel import (LogicalAxisRules, MeshSpec,
                                    PartitionSpec, build_mesh, replicated,
                                    shard_params, tree_specs)

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
CPU = torch.device("cpu")
MESHES = [dict(tp=2), dict(tp=4), dict(dp=2, fsdp=2, tp=2),
          dict(sp=2, tp=2), dict(pp=2, fsdp=2, tp=2)]
# The logical axes forward() constrains its activations to
# (ray_tpu/models/transformer.py:256-331).
ACTIVATIONS = [("batch", "seq", "embed"),
               ("batch", "seq", "heads", "head_dim"),
               ("batch", "seq", "kv_heads", "head_dim"),
               ("batch", "seq", "mlp"), ("batch", "seq", "vocab")]
ENGINE_OVERRIDES = (("vocab", None), ("embed", None))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _meshes(spec):
    n = MeshSpec(**spec).n_devices
    return (jax_build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:n]),
            build_mesh(MeshSpec(**spec), devices=[CPU] * n))


def _rules(overrides):
    return (JaxRules.default().with_overrides(*overrides),
            LogicalAxisRules.default().with_overrides(*overrides))


@pytest.mark.parametrize("overrides", [(), ENGINE_OVERRIDES])
@pytest.mark.parametrize("spec", MESHES)
def test_specs_match_jax_for_params_and_activations(spec, overrides):
    jmesh, mesh = _meshes(spec)
    jrules, rules = _rules(overrides)
    axes = dict(_leaves(param_logical_axes(CFG)))
    assert axes == dict(_leaves(jax_param_logical_axes(JCFG)))
    named = list(axes.items()) + [(str(a), a) for a in ACTIVATIONS]
    for name, logical in named:
        for m, jm in ((mesh, jmesh), (None, None)):
            got, want = rules.spec(logical, m), jrules.spec(logical, jm)
            assert isinstance(got, PartitionSpec) and isinstance(got, tuple)
            assert tuple(got) == tuple(want), (name, m)
    got = dict(_leaves(tree_specs(param_logical_axes(CFG), mesh, rules)))
    want = dict(_leaves(jax.tree.map(
        lambda s: s.spec, jax_tree_shardings(jax_param_logical_axes(JCFG),
                                             jmesh, jrules))))
    assert {k: tuple(v) for k, v in got.items()} \
        == {k: tuple(v) for k, v in want.items()}
    assert tuple(replicated(mesh)) == tuple(jax_replicated(jmesh).spec) == ()


def test_logical_rules_no_double_axis():
    """tests/test_models.py::test_logical_rules_no_double_axis: batch takes
    dp+fsdp, so embed must not reuse fsdp."""
    rules = LogicalAxisRules.default()
    mesh = build_mesh(MeshSpec(dp=2, fsdp=2, tp=2), devices=[CPU] * 8)
    spec = rules.spec(("batch", "seq", "embed"), mesh)
    assert spec[0] == ("dp", "fsdp")
    assert len(spec) == 2 or spec[2] is None


def test_rules_lookup_and_overrides_match_jax():
    jrules, rules = _rules(ENGINE_OVERRIDES)
    assert rules.rules == jrules.rules
    for name in ("batch", "vocab", "embed", "heads", "expert", "nope", None):
        assert rules._lookup(name) == jrules._lookup(name)
    assert repr(PartitionSpec("tp", None)) == "PartitionSpec('tp', None)"


def _jax_params(dtype):
    """The JAX engine's seed-0 ``tiny`` params in f32 or bf16 (norms f32),
    and the port's copy."""
    jcfg, cfg = JCFG, CFG
    if dtype == "bf16":
        jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    jp = JaxEngine(jcfg, max_batch=1, max_len=64, seed=0).params
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _bits(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _np_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("overrides", [(), ENGINE_OVERRIDES])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_params_bit_equal_to_jax_addressable_shards(n, dtype,
                                                          overrides):
    """Position i's tensor of every leaf is, bit for bit, the shard that
    jax.device_put places on the mesh's i-th device, under the default
    rules (vocab split too) and the engine's; replicated leaves are the
    params' own tensors."""
    jp, params = _jax_params(dtype)
    jmesh, mesh = _meshes(dict(tp=n))
    jrules, rules = _rules(overrides)
    placed = jax.device_put(jp, jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh, jrules))
    shards = shard_params(params, mesh, rules)
    assert len(shards) == n
    order = list(jmesh.devices.flat)
    mine = [dict(_leaves(s)) for s in shards]
    for name, arr in _leaves(placed):
        by_dev = {s.device: s.data for s in arr.addressable_shards}
        whole = dict(_leaves(params))[name]
        for i, dev in enumerate(order):
            got = mine[i][name]
            np.testing.assert_array_equal(_bits(got), _np_bits(by_dev[dev]))
            assert got.is_contiguous()
            if tuple(arr.sharding.spec) == () or got.shape == whole.shape:
                assert got is whole          # replicated: no copy


def test_tp_shards_takes_the_engine_rules_only():
    """tp_shards splits under megatron_rules() (heads, kv_heads, mlp) by
    default and under any other table as shard_params does (the default
    table's vocabulary slices are JAX's addressable shards); a dim that
    does not divide raises."""
    jp, params = _jax_params("f32")
    mesh = build_mesh(MeshSpec(tp=2), devices=[CPU] * 2)
    for rules in (None, LogicalAxisRules.default()):
        shards = tp_shards(params, mesh, rules)
        want = shard_params(params, mesh, rules or megatron_rules())
        for a, b in zip(shards, want):
            for (k, x), (_, y) in zip(_leaves(a), _leaves(b)):
                assert torch.equal(x, y), k
    jmesh, _ = _meshes(dict(tp=2))
    placed = jax.device_put(jp["embed"], jax_tree_shardings(
        jax_param_logical_axes(JCFG), jmesh, JaxRules.default())["embed"])
    by_dev = {d.device: d.data for d in placed.addressable_shards}
    for i, dev in enumerate(jmesh.devices.flat):
        np.testing.assert_array_equal(_bits(shards[i]["embed"]),
                                      _np_bits(by_dev[dev]))
    assert shards[0]["embed"].shape[0] == CFG.vocab_size // 2
    odd = build_mesh(MeshSpec(tp=3), devices=[CPU] * 3)
    with pytest.raises(ValueError, match="does not split over tp=3"):
        shard_params(params, odd, megatron_rules())
