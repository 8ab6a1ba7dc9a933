"""Parity of ray_tpu_torch.rllib's module and learners with the JAX
package on the CPU.

JAX params and learner states are carried across (``from_jax_params``,
``Learner.from_jax_state``), then the same numpy batches go through the
JAX learner (its jitted step and optax chain) and the port's (autograd and
``models.train_step.Adam``). All f32; XLA and PyTorch sum in different
orders, so values agree to f32 rounding: the module's outputs and V-trace
within 1e-6, the learners' params, targets and Adam moments within
PARAM_TOL absolute and their metrics within METRIC_TOL relative after one
``update`` (up to 24 Adam steps for PPO).
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import (APPOConfig as JaxAPPOConfig,
                           DQNConfig as JaxDQNConfig,
                           IMPALAConfig as JaxIMPALAConfig,
                           PPOConfig as JaxPPOConfig,
                           SACConfig as JaxSACConfig)
from ray_tpu.rllib import AppoLearner as JaxAppoLearner
from ray_tpu.rllib import DQNLearner as JaxDQNLearner
from ray_tpu.rllib import ImpalaLearner as JaxImpalaLearner
from ray_tpu.rllib import Learner as JaxLearner
from ray_tpu.rllib import RLModuleSpec as JaxRLModuleSpec
from ray_tpu.rllib import SACLearner as JaxSACLearner
from ray_tpu.rllib import vtrace as jax_vtrace
from ray_tpu_torch.rllib import (AppoLearner, DQNLearner, ImpalaLearner,
                                 Learner, RLModuleSpec, SACLearner, vtrace)
from ray_tpu_torch.rllib.learner import state_from_jax
from ray_tpu_torch.rllib.rl_module import (RLModule, from_jax_params,
                                           state_dict_from_jax)

SPEC = dict(obs_dim=4, num_actions=2, hiddens=(64, 64))
# One update is up to 24 Adam steps of lr 3e-4-6e-4; an element whose
# gradient is f32 noise may step the other way in one package.
PARAM_TOL = 1e-5
METRIC_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; these
    small shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_rl_module_views_match_jax():
    jmod = JaxRLModuleSpec(**SPEC).build()
    params = jmod.init(jax.random.key(3))
    mod = from_jax_params(_np(params), RLModuleSpec(**SPEC), "cpu")
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, 4)).astype(np.float32)
    actions = rng.integers(0, 2, 64).astype(np.int32)
    with torch.no_grad():
        logits, value = mod.logits_and_value(_t(obs))
        logp, ent, v2 = mod.forward_train(_t(obs), _t(actions))
        greedy = mod.forward_inference(_t(obs))
        a_s, logp_s, v_s = mod.forward_exploration(
            _t(obs), torch.Generator().manual_seed(0))
    jl, jv = jmod.logits_and_value(params, obs)
    jlogp, jent, _ = jmod.forward_train(params, obs, actions)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), atol=1e-6)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), atol=1e-6)
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(jmod.forward_inference(params, obs)))
    # The sampled actions' logp and the value, against JAX's at them.
    jlogp_s, _, _ = jmod.forward_train(params, obs, a_s.numpy())
    np.testing.assert_allclose(logp_s.numpy(), np.asarray(jlogp_s),
                               atol=1e-6)
    np.testing.assert_allclose(v_s.numpy(), np.asarray(jv), atol=1e-6)


def test_pi_only_weights_load_the_policy_head_alone():
    jmod = JaxRLModuleSpec(**SPEC).build()
    params = _np(jmod.init(jax.random.key(4)))
    mod = RLModule(RLModuleSpec(**SPEC), seed=1, device="cpu")
    vf_before = {k: v.clone() for k, v in mod.vf.state_dict().items()}
    mod.set_weights(state_dict_from_jax({"pi": params["pi"]}))
    obs = np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            mod.pi(_t(obs)).numpy(),
            np.asarray(jmod.logits_and_value(params, obs)[0]), atol=1e-6)
    for k, v in mod.vf.state_dict().items():
        assert torch.equal(v, vf_before[k])
    with pytest.raises(KeyError, match="missing"):
        mod.set_weights({"vf.0.bias": torch.zeros(64)})


def test_init_draws_the_reference_distribution():
    """Values differ from JAX's (another generator); the distribution is
    the same: normal x sqrt(2 / fan_in), zero biases, one seed one draw
    on any device."""
    a = RLModule(RLModuleSpec(4, 2, (256, 256)), seed=5, device="cpu")
    b = RLModule(RLModuleSpec(4, 2, (256, 256)), seed=5, device="cpu")
    w = a.pi[1].weight.detach()
    assert abs(float(w.std()) / np.sqrt(2 / 256) - 1) < 0.02
    assert abs(float(w.mean())) < 0.01
    assert all(not layer.bias.detach().any() for layer in a.pi)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])


def test_vtrace_matches_jax():
    rng = np.random.default_rng(2)
    T, B = 24, 6
    values = rng.normal(size=(T, B)).astype(np.float32)
    boot = rng.normal(size=B).astype(np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.15
    rhos = np.exp(0.5 * rng.normal(size=(T, B))).astype(np.float32)
    for rho_bar, c_bar in ((1.0, 1.0), (2.0, 0.9)):
        got = vtrace(_t(values), _t(boot), _t(rewards), _t(dones),
                     _t(rhos), 0.97, rho_bar, c_bar)
        want = jax_vtrace(values, boot, rewards, dones, rhos, 0.97,
                          rho_bar, c_bar)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


# ------------------------------------------------------------- learners --
def _ppo_samples(rng):
    T, N = 16, 4
    return [{
        "obs": rng.normal(size=(T, N, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
        "logp": (np.log(0.5) + 0.1 * rng.normal(size=(T, N))).astype(
            np.float32),
        "vf": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": np.ones((T, N), np.float32),
        "trunc_bonus": np.zeros((T, N), np.float32),
        "dones": rng.random((T, N)) < 0.1,
        "bootstrap_value": rng.normal(size=N).astype(np.float32),
    } for _ in range(2)]


def _impala_batch(rng):
    T, B = 16, 8
    return {
        "obs": rng.normal(size=(T, B, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
        "logp": (np.log(0.5) + 0.2 * rng.normal(size=(T, B))).astype(
            np.float32),
        "rewards": np.ones((T, B), np.float32),
        "trunc_bonus": np.where(rng.random((T, B)) < 0.05, 0.9, 0.0).astype(
            np.float32),
        "dones": rng.random((T, B)) < 0.1,
        "final_obs": rng.normal(size=(B, 4)).astype(np.float32),
        "episode_returns": [12.0, 30.0],
    }


def _transition_batch(rng, prioritized=False):
    n = 64
    batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "rewards": np.ones(n, np.float32),
        "dones": rng.random(n) < 0.1,
        "discounts": np.full(n, 0.99 ** 3, np.float32),
    }
    if prioritized:
        batch["weights"] = rng.uniform(0.3, 1.0, n).astype(np.float32)
    return batch


CASES = {
    "ppo": (JaxLearner, Learner,
            JaxPPOConfig().training(minibatch_size=32, entropy_coeff=0.01),
            lambda rng: _ppo_samples(rng)),
    "impala": (JaxImpalaLearner, ImpalaLearner, JaxIMPALAConfig(),
               _impala_batch),
    "appo": (JaxAppoLearner, AppoLearner, JaxAPPOConfig(), _impala_batch),
    "dqn": (JaxDQNLearner, DQNLearner,
            JaxDQNConfig().training(target_network_update_freq=2),
            lambda rng: _transition_batch(rng, prioritized=True)),
    "sac": (JaxSACLearner, SACLearner, JaxSACConfig(), _transition_batch),
}


def _close(got: dict, want: dict, atol, what):
    assert got.keys() == want.keys(), (what, got.keys(), want.keys())
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=atol, rtol=0, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_update_from_carried_state_matches_jax(name):
    jax_cls, cls, config, make_batch = CASES[name]
    cfg = config.learner_config_dict()
    rng = np.random.default_rng(11)
    jl = jax_cls(SPEC, cfg, seed=0)
    # One JAX update first, so the carried Adam state is not zeros.
    jl.update(make_batch(rng))
    state = _np(jl.get_state())
    port = cls.from_jax_state(state, SPEC, cfg, device="cpu", seed=0)
    mine = port.get_state()
    carried = state_from_jax(state)
    _close(mine["params"], carried["params"], 0, "carried params")
    assert mine["opt_state"]["count"] == carried["opt_state"]["count"] > 0
    _close(mine["opt_state"]["mu"], carried["opt_state"]["mu"], 0, "mu")
    if name in ("ppo", "dqn"):
        # The numpy generator draws the same minibatch orders only if
        # both are at the same point: the JAX learner drew once already.
        port._rng = np.random.default_rng(0)
        jl._rng = np.random.default_rng(0)

    batch = make_batch(rng)
    want_m = jl.update(dict(batch) if isinstance(batch, dict) else batch)
    got_m = port.update(dict(batch) if isinstance(batch, dict) else batch)
    want = state_from_jax(_np(jl.get_state()))
    got = port.get_state()
    _close(got["params"], want["params"], PARAM_TOL, "params")
    assert got["opt_state"]["count"] == want["opt_state"]["count"] > \
        carried["opt_state"]["count"]
    _close(got["opt_state"]["mu"], want["opt_state"]["mu"], PARAM_TOL, "mu")
    _close(got["opt_state"]["nu"], want["opt_state"]["nu"], PARAM_TOL, "nu")
    for key in ("target_params", "target"):
        if key in want:
            _close(got[key], want[key], PARAM_TOL, key)
    assert got.get("updates") == want.get("updates")
    assert got_m.keys() == want_m.keys()
    for k, w in want_m.items():
        g = got_m[k]
        if k == "td_errors":
            np.testing.assert_allclose(g, w, atol=METRIC_TOL, rtol=0)
        elif isinstance(w, list):
            assert g == w
        else:
            np.testing.assert_allclose(g, w, rtol=METRIC_TOL,
                                       atol=METRIC_TOL, err_msg=k)
