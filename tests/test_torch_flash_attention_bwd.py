"""Parity of ray_tpu_torch's attention backward with the JAX package on the CPU.

The same numpy q, k, v and dO go through ``jax.vjp`` of JAX's
``flash_attention`` (which takes its reference path off the TPU, as
tests/test_ops.py relies on) and through the port: its plain backward
``reference_attention_bwd`` and autograd through ``flash_attention``,
which on the CPU runs the ``_FlashAttention`` Function on its plain
halves. The CUDA kernels themselves are held against these plain versions
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jax_flash_attention
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import (
    _check_rows, attention_bwd_delta, flash_attention, flash_attention_bwd,
    flash_attention_dkv, flash_attention_dq, flash_attention_fwd,
    reference_attention_bwd, reference_attention_dkv, reference_attention_dq,
    reference_attention_lse)

# f32 on both sides; the port recomputes P = exp(S - lse) where JAX
# differentiates the softmax, and sums in another order.
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


SHAPES = [  # (B, S, Hq, Hkv, D), as in tests/test_torch_flash_attention.py
    (2, 32, 4, 2, 16),
    (2, 24, 4, 4, 16),
    (1, 40, 8, 2, 16),
    (1, 32, 4, 4, 128),
    (2, 16, 4, 2, 128),
    (1, 24, 8, 2, 128),
]
_ids = lambda s: "x".join(map(str, s))  # noqa: E731


def _inputs(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, h, D)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv, Hq))


def _jax_vjp(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda *a: jax_flash_attention(*a, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_reference_backward_matches_jax_vjp(shape, causal):
    q, k, v, do = _inputs(*shape)
    want = _jax_vjp(q, k, v, do, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = reference_attention_lse(tq, tk, tv, causal=causal)
    got = reference_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name)
    # On CPU tensors the kernel path is the plain one, exactly.
    for g, w in zip(flash_attention_bwd(tq, tk, tv, o, lse, tdo,
                                        causal=causal), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_autograd_function_matches_jax_vjp(shape, causal):
    q, k, v, do = _inputs(*shape, seed=1)
    want = _jax_vjp(q, k, v, do, causal)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_twins_split_the_backward(causal):
    """dQ (with delta) and dK/dV each have their own plain twin, which the
    kernel wrappers run on CPU tensors; together they are the backward."""
    tq, tk, tv, tdo = map(torch.from_numpy, _inputs(2, 20, 8, 2, 16, 2))
    o, lse = reference_attention_lse(tq, tk, tv, causal=causal, scale=0.3)
    delta = attention_bwd_delta(o, tdo)
    assert delta.shape == (2, 8, 20) and delta.is_contiguous()
    torch.testing.assert_close(
        delta, (tdo * o).sum(-1).transpose(1, 2), rtol=0, atol=0)
    dq, kdelta = flash_attention_dq(tq, tk, tv, o, tdo, lse, causal, 0.3)
    torch.testing.assert_close(kdelta, delta, rtol=0, atol=0)
    dk, dv = flash_attention_dkv(tq, tk, tv, tdo, lse, delta, causal, 0.3)
    for g, w in zip((dq, kdelta), reference_attention_dq(
            tq, tk, tv, o, tdo, lse, causal, 0.3)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, w in zip((dk, dv), reference_attention_dkv(
            tq, tk, tv, tdo, lse, delta, causal, 0.3)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, w in zip((dq, dk, dv), reference_attention_bwd(
            tq, tk, tv, o, lse, tdo, causal, 0.3)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_dq_twin_delta_and_dq_match_jax(shape, causal):
    """The dQ twin's delta against numpy's rowsum of the JAX forward's o
    times dO (the reference's ``:270``), and its dq against ``jax.vjp``'s,
    with the JAX forward's o as the twin's input."""
    q, k, v, do = _inputs(*shape, seed=4)
    o = np.array(jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal))
    want_delta = (do * o).sum(-1).transpose(0, 2, 1)
    want_dq = _jax_vjp(q, k, v, do, causal)[0]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    _, lse = reference_attention_lse(tq, tk, tv, causal=causal)
    dq, delta = reference_attention_dq(tq, tk, tv, torch.from_numpy(o), tdo,
                                       lse, causal=causal)
    assert delta.dtype == torch.float32 and delta.is_contiguous()
    np.testing.assert_allclose(delta.numpy(), want_delta, rtol=TOL,
                               atol=TOL, err_msg="delta")
    np.testing.assert_allclose(dq.numpy(), want_dq, rtol=TOL, atol=TOL,
                               err_msg="dq")


def test_cpu_backward_launches_no_kernel():
    counters = (flash_attention_fwd, flash_attention_dq, flash_attention_dkv)
    before = [f.launches for f in counters]
    leaves = [torch.from_numpy(x).requires_grad_()
              for x in _inputs(1, 8, 4, 2, 16)[:3]]
    flash_attention(*leaves).sum().backward()
    assert all(t.grad is not None for t in leaves)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_plain_forward_and_backward_f64(causal):
    """The Function's plain halves are a consistent (forward, backward)
    pair: finite differences of the forward agree with the backward."""
    rng = np.random.default_rng(3)
    leaves = [torch.from_numpy(rng.normal(size=(1, 6, h, 8)))
              .requires_grad_() for h in (4, 2, 2)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, causal=causal), leaves)


def test_non_cpu_backward_never_takes_the_plain_path():
    """Off the CPU the backward launches its kernels or raises: meta
    tensors stand in for a device the kernels do not take."""
    q, k, v, do = (torch.empty((1, 8, h, 64), device="meta")
                   for h in (4, 2, 2, 4))
    lse = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, q, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_dq(q, k, v, q, do, lse)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_dkv(q, k, v, do, lse, lse)


def test_row_inputs_are_checked():
    q = torch.zeros((2, 8, 4, 16))
    _check_rows(q, lse=torch.zeros((2, 4, 8)))
    for bad in (torch.zeros((2, 8, 4)), torch.zeros((2, 4, 8)).double(),
                torch.zeros((2, 8, 4)).transpose(1, 2)):
        with pytest.raises(ValueError, match="lse"):
            _check_rows(q, lse=bad)


def test_backward_kernel_sources_are_found():
    assert {"flash_attention_dq", "flash_attention_dkv"} <= set(
        _build.kernel_names())


def test_editing_a_shared_header_rebuilds(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.kernel_names() == ["k"]
    before = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// b\n")
    assert _build.library_path("k") != before
