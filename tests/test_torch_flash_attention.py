"""Parity of ray_tpu_torch's flash attention with the JAX package on the CPU.

The same numpy inputs go through JAX's ``flash_attention`` (which takes its
reference path off the TPU) and the port's; on the CPU the port's wrapper
runs its plain PyTorch version. The CUDA kernel itself is checked against
that plain version on the card by chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jax_flash_attention
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_fwd,
                                               reference_attention,
                                               reference_attention_lse)

# f32 on both sides; only the order of the sums differs.
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them, and these
    small shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SHAPES = [  # (B, S, Hq, Hkv, D)
    (2, 32, 4, 2, 16),      # tests/test_ops.py's shape
    (2, 24, 4, 4, 16),
    (1, 40, 8, 2, 16),
    (1, 32, 4, 4, 128),
    (2, 16, 4, 2, 128),
    (1, 24, 8, 2, 128),
]


def _qkv(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, h, D)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))


def _jax_lse(q, k, causal):
    """logsumexp over keys of JAX's masked, scaled f32 scores: (B,Hq,S)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = jnp.asarray(q).reshape(B, S, Hkv, Hq // Hkv, D)
    s = jnp.einsum("bskgd,btkd->bkgst", qg, jnp.asarray(k)) / math.sqrt(D)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool)), s, -1e30)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, Hq, S)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_matches_jax(shape, causal):
    q, k, v = _qkv(*shape)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for fn in (flash_attention, reference_attention):
        got = fn(tq, tk, tv, causal=causal).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "x".join(
    map(str, s)))
def test_lse_matches_jax_logsumexp(shape, causal):
    q, k, v = _qkv(*shape, seed=1)
    o, lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal)
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal),
                               rtol=TOL, atol=TOL)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(o.numpy(), want, rtol=TOL, atol=TOL)


def test_cpu_path_launches_no_kernel():
    before = flash_attention_fwd.launches
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 4, 2, 16))
    flash_attention(q, k, v)
    flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches == before


def test_reference_lse_matches_reference_output():
    q, k, v = map(torch.from_numpy, _qkv(2, 20, 8, 4, 16, seed=2))
    for causal in (True, False):
        o, _ = reference_attention_lse(q, k, v, causal=causal, scale=0.3)
        ref = reference_attention(q, k, v, causal=causal, scale=0.3)
        torch.testing.assert_close(o, ref, rtol=0, atol=0)


def test_non_cpu_tensors_never_take_the_plain_path():
    """Off the CPU the wrapper launches the kernel or raises: meta tensors
    stand in for a device the kernel does not take. A tensor that needs a
    gradient goes through the autograd Function, whose forward launches
    the kernel or raises the same way."""
    q, k, v = (torch.empty((1, 8, h, 64), device="meta") for h in (4, 2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, k, v)
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_kernel_sources_are_found():
    assert "flash_attention_fwd" in _build.kernel_names()
    path = _build.library_path("flash_attention_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path.suffix == ".so"
