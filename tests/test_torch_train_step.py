"""Parity of ray_tpu_torch's training step with the JAX package on the CPU.

JAX params and train states are carried across (``from_jax_params``,
``from_jax_state``); the same numpy batches go through JAX's ``loss_fn``,
``jax.grad`` and ``make_train_step`` (on a one-device mesh, with its optax
chain) and through the port's, which runs its plain attention halves on
the CPU. ``PRESETS["tiny"]`` is f32, so the tolerances are f32 ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models import loss_fn as jax_loss_fn
from ray_tpu.models import make_eval_step as jax_make_eval_step
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models.train_step import make_optimizer as jax_make_optimizer
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu_torch.models import (PRESETS, from_jax_params, from_jax_state,
                                  loss_fn, make_eval_step, make_optimizer,
                                  make_train_step)
from ray_tpu_torch.models.train_step import global_norm, value_and_grad
from ray_tpu_torch.parallel import MeshSpec as TorchMeshSpec
from ray_tpu_torch.parallel import build_mesh as torch_build_mesh

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
# f32 through two layers and a 512-way softmax: the order of the sums
# differs (XLA on the CPU against PyTorch's CPU kernels), nothing else.
TOL = 1e-5
STEPS = 5
LR = 3e-4                     # make_optimizer's default peak learning rate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them, and these
    small shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab_size, shape).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _stacked(grads):
    """The port's per-layer grads (a list of layer dicts) stacked back into
    the JAX (L, ...) layout."""
    layers = grads["layers"]

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return torch.stack(nodes)
    return {**grads, "layers": stack(*layers)}


def _assert_tree_close(got, want, atol, rtol=0.0):
    want = dict(_leaves(_np(want)))
    got = dict(_leaves(got))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(JCFG, jax.random.key(0))


@pytest.fixture(scope="module")
def jax_bundle():
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    return jax_make_train_step(JCFG, mesh,
                               optimizer=jax_make_optimizer(warmup_steps=1))


def test_loss_fn_matches_jax_in_both_batch_forms(jparams):
    tp = from_jax_params(_np(jparams), CFG, "cpu")
    toks = _tokens((2, 17), 0)
    want = float(jax_loss_fn(jparams, {"tokens": jnp.asarray(toks)}, JCFG))
    got = loss_fn(tp, {"tokens": torch.from_numpy(toks)}, CFG, device="cpu")
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=TOL)

    inputs, targets = _tokens((2, 12), 1), _tokens((2, 12), 2)
    targets[0, 7:] = 0                  # padding id 0 carries no weight
    targets[1, :3] = 0
    batch = {"inputs": inputs, "targets": targets}
    want = float(jax_loss_fn(jparams, jax.tree.map(jnp.asarray, batch), JCFG))
    got = loss_fn(tp, jax.tree.map(torch.from_numpy, batch), CFG,
                  device="cpu")
    np.testing.assert_allclose(float(got), want, rtol=TOL)
    # A batch without padding agrees too, and all-padding gives a loss of
    # 0 (the weight sum is clamped to 1), not a division by 0.
    unpadded = {"inputs": inputs[:1, :7], "targets": targets[:1, :7]}
    np.testing.assert_allclose(
        float(loss_fn(tp, jax.tree.map(torch.from_numpy, unpadded), CFG,
                      device="cpu")),
        float(jax_loss_fn(jparams, jax.tree.map(jnp.asarray, unpadded),
                          JCFG)), rtol=TOL)
    zero = {"inputs": inputs, "targets": np.zeros_like(targets)}
    assert float(loss_fn(tp, jax.tree.map(torch.from_numpy, zero), CFG,
                         device="cpu")) == 0.0


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_grads_of_every_param_match_jax(jparams, impl, remat):
    jcfg = dataclasses.replace(JCFG, attention_impl=impl, remat=remat)
    tcfg = dataclasses.replace(CFG, attention_impl=impl, remat=remat)
    toks = _tokens((2, 21), 3)
    jloss, jgrads = jax.value_and_grad(jax_loss_fn)(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tp = from_jax_params(_np(jparams), CFG, "cpu")
    before = {n: t.clone() for n, t in _leaves(tp)}
    loss, grads = value_and_grad(tp, {"tokens": torch.from_numpy(toks)},
                                 tcfg, device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert len(grads["layers"]) == CFG.num_layers
    _assert_tree_close(_stacked(grads), jgrads, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(optax.global_norm(jgrads)), rtol=TOL)
    for name, t in _leaves(tp):           # the params are left as they were
        assert not t.requires_grad and torch.equal(t, before[name]), name


@pytest.mark.parametrize("warmup,decay", [(1, 10000), (5, 20), (3, 2),
                                          (0, 10)])
def test_schedule_matches_optax(warmup, decay):
    lr = 3e-4
    want = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(decay, warmup + 1))
    opt = make_optimizer(learning_rate=lr, warmup_steps=warmup,
                         decay_steps=decay)
    counts = range(max(decay, warmup + 1) + 4)
    # optax computes in f32: near the end of the cosine 1 + cos(x) keeps
    # only lr * 2**-23 absolute, where the port computes in f64.
    np.testing.assert_allclose([opt.schedule(c) for c in counts],
                               [float(want(c)) for c in counts],
                               rtol=1e-6, atol=lr * 2.0 ** -23)
    if warmup:
        assert opt.schedule(0) == 0.0     # the first update does not move


def _check_step(jm, tm):
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=TOL)
    np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                               rtol=TOL)
    assert tm["step"] == int(jm["step"])


def _assert_params_close(got, want, lr_steps):
    """Params after the same Adam steps: within TOL, except where Adam
    normalised a gradient element that is f32 noise. Such an element (a
    gradient of ~1e-8 where the median is ~1e-4, from cancellation) has
    m / sqrt(v) of order 1 on both sides but not the same value, so its
    param moves by a different fraction of lr. Those may be at most 1e-4
    of the elements, and at most 2 lr per step with a non-zero lr apart
    (an Adam step moves an element by about lr at most)."""
    want = dict(_leaves(want))
    for name, g in _leaves(got):
        diff = np.abs(g.detach().numpy() - want[name])
        noisy = diff > TOL
        assert noisy.mean() <= 1e-4, (name, noisy.sum())
        assert diff.max() <= 2 * LR * lr_steps, (name, diff.max())


def _check_state(ts, js, lr_steps):
    """Params and Adam moments after the same steps."""
    _assert_params_close(ts["params"], js["params"], lr_steps)
    adam = js["opt_state"][1][0]
    _assert_tree_close(ts["opt_state"]["mu"], adam.mu, atol=TOL)
    _assert_tree_close(ts["opt_state"]["nu"], adam.nu, atol=TOL)
    assert ts["opt_state"]["count"] == int(adam.count)
    assert ts["opt_state"]["schedule_count"] == int(
        js["opt_state"][1][2].count)
    assert ts["step"] == int(js["step"])


def test_five_step_trajectory_matches_jax(jax_bundle):
    js = jax_bundle.init(jax.random.key(0))
    ts = from_jax_state(_np(js), CFG, "cpu")
    init = {n: t.clone() for n, t in _leaves(ts["params"])}
    tb = make_train_step(CFG, optimizer=make_optimizer(warmup_steps=1),
                         device="cpu")
    toks = _tokens((4, 33), 0)
    for i in range(STEPS):
        js, jm = jax_bundle.step(js, {"tokens": jnp.asarray(toks)})
        ts, tm = tb.step(ts, {"tokens": torch.from_numpy(toks)})
        _check_step(jm, tm)
        if i == 0:     # the schedule's count starts at 0: lr 0, no move
            for name, t in _leaves(ts["params"]):
                assert torch.equal(t, init[name]), name
    assert tm["loss"] < float(jm["loss"]) + TOL
    _check_state(ts, _np(js), lr_steps=STEPS - 1)


def test_from_jax_state_continues_a_jax_run(jax_bundle):
    js = jax_bundle.init(jax.random.key(1))
    toks = _tokens((4, 33), 4)
    jbatch = {"tokens": jnp.asarray(toks)}
    for _ in range(2):
        js, _ = jax_bundle.step(js, jbatch)
    np_state = _np(js)
    ts = from_jax_state(np_state, CFG, "cpu")
    _assert_tree_close(ts["params"], np_state["params"], atol=0)
    _check_state(ts, np_state, lr_steps=0)    # a bit-exact copy
    assert ts["step"] == 2 and ts["opt_state"]["count"] == 2
    tb = make_train_step(CFG, optimizer=make_optimizer(warmup_steps=1),
                         device="cpu")
    for _ in range(3):
        js, jm = jax_bundle.step(js, jbatch)
        ts, tm = tb.step(ts, {"tokens": torch.from_numpy(toks)})
        _check_step(jm, tm)
    _check_state(ts, _np(js), lr_steps=3)


def test_from_jax_state_rejects_another_optimizer_state(jparams):
    state = {"params": _np(jparams), "opt_state": (), "step": np.int32(0)}
    with pytest.raises(ValueError, match="opt_state"):
        from_jax_state(state, CFG, "cpu")


def test_eval_step_matches_jax(jparams):
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    toks = _tokens((3, 19), 5)
    want = float(jax_make_eval_step(JCFG, mesh)(
        jparams, {"tokens": jnp.asarray(toks)}))
    tp = from_jax_params(_np(jparams), CFG, "cpu")
    got = make_eval_step(CFG, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), want, rtol=TOL)


def test_init_and_undonated_step():
    """init draws params and zero moments in the params' dtypes; without
    donation the step leaves its input state as it was."""
    tb = make_train_step(CFG, optimizer=make_optimizer(warmup_steps=1),
                         donate_state=False, device="cpu")
    state = tb.init(torch.Generator().manual_seed(0))
    assert state["step"] == 0 and state["opt_state"]["count"] == 0
    for (name, p), (_, m) in zip(_leaves(state["params"]),
                                 _leaves(state["opt_state"]["mu"])):
        assert m.dtype == p.dtype and m.shape == p.shape and not m.any()
    before = {n: t.clone() for n, t in _leaves(state["params"])}
    toks = torch.from_numpy(_tokens((2, 9), 6))
    new, _ = tb.step(state, {"tokens": toks})
    new, m = tb.step(new, {"tokens": toks})
    assert m["step"] == 2 and state["step"] == 0
    for name, t in _leaves(state["params"]):
        assert torch.equal(t, before[name]), name
    assert any(not torch.equal(t, before[n])
               for n, t in _leaves(new["params"]))


def test_train_step_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(CFG)


def test_unported_train_options_raise():
    # Every train option is ported now: a mesh with pipeline stages
    # (tests/test_torch_train_pp.py) builds, and num_microbatches without
    # a pp axis is ignored, as JAX's make_train_step ignores it.
    pp2 = torch_build_mesh(TorchMeshSpec(pp=2), devices=["cpu"] * 2)
    tb = make_train_step(CFG, mesh=pp2, device="cpu")
    assert tb.mesh is pp2
    batch = {"tokens": torch.from_numpy(_tokens((2, 17), 3))}
    metrics = []
    for mb in (None, 2):
        b = make_train_step(CFG, num_microbatches=mb, device="cpu")
        _, m = b.step(b.init(torch.Generator().manual_seed(0)), batch)
        metrics.append(m)
    assert metrics[0] == metrics[1]
