"""Parity of ray_tpu_torch's transformer with the JAX package on the CPU.

JAX params are carried across with ``from_jax_params``; the same numpy
tokens go through JAX ``forward`` and the port's.
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
from ray_tpu.models.transformer import apply_rope as jax_apply_rope
from ray_tpu.models.transformer import rms_norm as jax_rms_norm
from ray_tpu.models.transformer import rope_angles as jax_rope_angles
from ray_tpu_torch.models import (PRESETS, forward, from_jax_params,
                                  init_params)
from ray_tpu_torch.models.transformer import (_attention, apply_rope,
                                              rms_norm, rope_angles)
from ray_tpu_torch.parallel import MeshSpec, build_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them, and these
    small shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny():
    jp = jax_init_params(JAX_PRESETS["tiny"], jax.random.key(0))
    return jp, from_jax_params(_np_tree(jp), PRESETS["tiny"], "cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_from_jax_params_copies_tiny_exactly(tiny):
    jp, tp = tiny
    got = dict(_leaves(tp))
    want = dict(_leaves(_np_tree(jp)))
    assert got.keys() == want.keys()
    for name, arr in want.items():
        assert got[name].dtype == torch.float32, name
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)


def test_from_jax_params_bf16_nano_is_bit_exact():
    jp = _np_tree(jax_init_params(JAX_PRESETS["nano"], jax.random.key(1)))
    tp = from_jax_params(jp, PRESETS["nano"], "cpu")
    got = dict(_leaves(tp))
    for name, arr in _leaves(jp):
        t = got[name]
        if arr.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), arr.view(np.int16),
                err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), arr, err_msg=name)


def test_from_jax_params_rejects_another_config(tiny):
    jp, _ = tiny
    with pytest.raises(ValueError, match="wq"):
        from_jax_params(_np_tree(jp), PRESETS["nano"], "cpu")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match_jax(tiny, impl):
    jp, tp = tiny
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], attention_impl=impl)
    tcfg = dataclasses.replace(PRESETS["tiny"], attention_impl=impl)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want = np.asarray(jax_forward(jp, jnp.asarray(tokens), jcfg))
    got = forward(tp, torch.from_numpy(tokens), tcfg, device="cpu")
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    ang = rng.uniform(-3, 3, size=(12, 8)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(cos),
                                     jnp.asarray(sin)))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                     torch.from_numpy(sin))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_rope_angles_match_jax():
    cfg = PRESETS["8b-gqa"]
    jc, js = jax_rope_angles(64, cfg.head_dim_, cfg.rope_theta, offset=3)
    tc, ts = rope_angles(64, cfg.head_dim_, cfg.rope_theta, offset=3)
    # Angles up to ~66 rad in f32: one ulp of the angle is ~4e-6.
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_init_params_matches_jax_layouts():
    cfg = PRESETS["nano"]
    want = dict(_leaves(_np_tree(jax_init_params(JAX_PRESETS["nano"],
                                                 jax.random.key(0)))))
    got = dict(_leaves(init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")))
    assert got.keys() == want.keys()
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
        assert str(got[name].dtype).replace("torch.", "") == arr.dtype.name
    wq = got["/layers/attn/wq"].float()
    assert abs(wq.std().item() - cfg.hidden_size ** -0.5) < 5e-3


def test_param_count_matches_jax():
    for name, cfg in PRESETS.items():
        assert cfg.param_count() == JAX_PRESETS[name].param_count(), name
        assert cfg.head_dim_ == JAX_PRESETS[name].head_dim_, name
        assert cfg.dtype == (torch.float32 if name == "tiny"
                             else torch.bfloat16)


def test_config_defaults_and_presets_match_jax():
    """Every field the port's TransformerConfig shares with JAX's has the
    same default, and every preset the same values (dtype mapped)."""
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    jax_fields = {f.name: f for f in dataclasses.fields(JAX_PRESETS["tiny"])}
    shared = [f for f in dataclasses.fields(PRESETS["tiny"])
              if f.name in jax_fields]
    # Every field of either is in both (sp_degree included).
    assert {f.name for f in shared} == {
        f.name for f in dataclasses.fields(PRESETS["tiny"])} == set(
            jax_fields)
    for f in shared:
        want = jax_fields[f.name].default
        assert f.default == dtypes.get(want, want), f.name
    assert PRESETS.keys() == JAX_PRESETS.keys()
    for name, cfg in PRESETS.items():
        for f in shared:
            want = getattr(JAX_PRESETS[name], f.name)
            assert getattr(cfg, f.name) == dtypes.get(want, want), (name,
                                                                   f.name)


def test_flops_per_token_matches_jax():
    for name, cfg in PRESETS.items():
        for s in (None, 2048):
            assert cfg.flops_per_token(s) == JAX_PRESETS[
                name].flops_per_token(s), name


def test_entry_points_default_to_cuda_and_raise_without_it(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = PRESETS["tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forward(tiny[1], torch.zeros((1, 4), dtype=torch.long), cfg)


def test_unported_options_raise(tiny):
    tp = tiny[1]
    toks = torch.zeros((1, 4), dtype=torch.long)
    q = k = v = torch.zeros((1, 4, 2, 16))
    # ring is ported: with no mesh it is plain attention, as in JAX (its
    # parity over a mesh is in tests/test_torch_ring_attention.py).
    torch.testing.assert_close(
        _attention(dataclasses.replace(PRESETS["tiny"],
                                       attention_impl="ring"), q, k, v),
        _attention(PRESETS["tiny"], q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError, match="attention_impl"):
        _attention(dataclasses.replace(PRESETS["tiny"],
                                       attention_impl="bogus"), q, k, v)
    # remat is ported: per-layer checkpointing only under grad, so the
    # logits are the same with and without it.
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, PRESETS["tiny"].vocab_size, (2, 12)))
    no_remat = dataclasses.replace(PRESETS["tiny"], remat=False)
    want = forward(tp, toks, no_remat, device="cpu")
    torch.testing.assert_close(forward(tp, toks, dataclasses.replace(
        PRESETS["tiny"], remat=True), device="cpu"), want, rtol=0, atol=0)
    # Meshes: sp-only is ported; dp/fsdp/tp and pp (pipeline stages) are
    # not, and raise.
    for spec in (dict(dp=2), dict(tp=2, sp=2), dict(fsdp=2), dict(pp=2)):
        mesh = build_mesh(MeshSpec(**spec),
                          devices=["cpu"] * MeshSpec(**spec).n_devices)
        with pytest.raises(NotImplementedError, match="mesh"):
            forward(tp, toks, PRESETS["tiny"], mesh=mesh, device="cpu")
    sp2 = build_mesh(MeshSpec(sp=2), devices=["cpu"] * 2)
    torch.testing.assert_close(
        forward(tp, toks, PRESETS["tiny"], mesh=sp2, device="cpu"),
        forward(tp, toks, PRESETS["tiny"], device="cpu"), rtol=0, atol=0)
