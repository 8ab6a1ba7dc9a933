"""ray_tpu_torch.rllib's offline algorithms (BC, MARWIL, CQL, IQL) on the
CPU, against the JAX package.

The episode flatteners are numpy in both packages and must agree exactly.
A learner continues a JAX learner's state (``Learner.from_jax_state``),
both numpy generators restarted from one seed, so one update draws the
same minibatches in both; params, targets, Adam's moments and the metrics
then agree to f32 rounding (PARAM_TOL, METRIC_TOL). Greedy evaluation
from carried weights must take the same actions step for step, which is
meaningful only where no logit gap along the rollout is within rounding of
zero (MIN_GAP). Then the port alone passes the JAX tests' learning gates
(tests/test_rllib_sac_offline.py, tests/test_rllib_cql_iql.py) on corpora
recorded with the port's CartPole, which is gymnasium's bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_rllib_envs import (random_cartpole_episodes, record_cartpole,
                               scripted_cartpole_episodes)
from _torch_rllib_helpers import SPEC
from ray_tpu.rllib import BCConfig as JaxBCConfig
from ray_tpu.rllib import BCLearner as JaxBCLearner
from ray_tpu.rllib import CQLConfig as JaxCQLConfig
from ray_tpu.rllib import IQLConfig as JaxIQLConfig
from ray_tpu.rllib import MARWILConfig as JaxMARWILConfig
from ray_tpu.rllib import episodes_to_batch as jax_episodes_to_batch
from ray_tpu.rllib import (episodes_to_transitions as
                           jax_episodes_to_transitions)
from ray_tpu.rllib.cql import CQLLearner as JaxCQLLearner
from ray_tpu.rllib.iql import IQLLearner as JaxIQLLearner
from ray_tpu.rllib.offline import greedy_rollout as jax_greedy_rollout
from ray_tpu_torch.rllib import (BCConfig, BCLearner, CQLConfig, IQLConfig,
                                 MARWILConfig, RLModule, RLModuleSpec,
                                 episodes_to_batch, episodes_to_transitions)
from ray_tpu_torch.rllib.cql import CQLLearner
from ray_tpu_torch.rllib.iql import IQLLearner
from ray_tpu_torch.rllib.learner import state_from_jax
from ray_tpu_torch.rllib.offline import greedy_rollout

# One update is up to 24 Adam steps at lr 1e-3-2e-3; an element whose
# gradient is f32 noise may step the other way in one package.
PARAM_TOL = 1e-5
METRIC_TOL = 1e-5
# The smallest logit (or Q) gap along a greedy rollout for equal actions
# to be a comparison rather than a coin toss: far above f32 rounding.
MIN_GAP = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)




# ------------------------------------------------------------ flatteners --
def _episode(rng, T, terminated=None, rewards=True):
    ep = {"obs": rng.normal(size=(T, 3)).astype(np.float32),
          "actions": rng.integers(0, 2, T)}
    if rewards:
        ep["rewards"] = rng.normal(size=T).astype(np.float32)
    if terminated is not None:
        ep["terminated"] = terminated
    return ep


CORPORA = {
    "terminal": lambda rng: [_episode(rng, 5, True), _episode(rng, 1)],
    "truncated": lambda rng: [_episode(rng, 4, False),
                              _episode(rng, 6, True)],
    "one_step_truncated": lambda rng: [_episode(rng, 1, False),
                                       _episode(rng, 3, False),
                                       _episode(rng, 2, True)],
    "no_rewards": lambda rng: [_episode(rng, 4, rewards=False)],
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_episode_flatteners_equal_jax(name):
    episodes = CORPORA[name](np.random.default_rng(3))
    for got, want in (
            (episodes_to_batch(episodes, 0.9),
             jax_episodes_to_batch(episodes, 0.9)),
            (episodes_to_transitions(episodes),
             jax_episodes_to_transitions(episodes))):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("episodes", [[], [{"obs": np.zeros((1, 2)),
                                            "actions": [0],
                                            "terminated": False}]],
                         ids=["empty", "one_truncated_step"])
def test_a_corpus_without_transitions_raises_as_jax_does(episodes):
    with pytest.raises(ValueError) as want:
        jax_episodes_to_transitions(episodes)
    with pytest.raises(ValueError) as got:
        episodes_to_transitions(episodes)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------------- learners --
def _bc_corpus(rng, n=300):
    eps = [{"obs": rng.normal(size=(n // 3, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n // 3),
            "rewards": rng.uniform(0, 1, n // 3).astype(np.float32)}
           for _ in range(3)]
    return jax_episodes_to_batch(eps, 0.99)


def _transitions(rng, n=200):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}


BC_TRAINING = dict(minibatch_size=64, num_epochs=2)
LEARNERS = {
    "bc": (JaxBCLearner, BCLearner,
           JaxBCConfig().training(**BC_TRAINING)),
    "marwil_beta1": (JaxBCLearner, BCLearner,
                     JaxMARWILConfig().training(**BC_TRAINING)),
    "marwil_beta2": (JaxBCLearner, BCLearner,
                     JaxMARWILConfig().training(beta=2.0, **BC_TRAINING)),
    "cql": (JaxCQLLearner, CQLLearner, JaxCQLConfig()),
    "iql": (JaxIQLLearner, IQLLearner, JaxIQLConfig()),
}


def _update(learner, data):
    if isinstance(learner, (JaxBCLearner, BCLearner)):
        return learner.update_offline(dict(data))
    return learner.run_updates(data, 3, 64)


def _close(got: dict, want: dict, what):
    assert got.keys() == want.keys(), (what, got.keys(), want.keys())
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=PARAM_TOL, rtol=0,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_one_update_from_carried_state_matches_jax(name):
    jax_cls, cls, config = LEARNERS[name]
    cfg = config.learner_config_dict()
    rng = np.random.default_rng(5)
    data = (_bc_corpus(rng) if cls is BCLearner else _transitions(rng))
    jl = jax_cls(SPEC, cfg, seed=0)
    # One JAX update first, so the carried Adam state is not zeros.
    _update(jl, data)
    carried = _np(jl.get_state())
    port = cls.from_jax_state(carried, SPEC, cfg, device="cpu", seed=0)
    jl._rng = np.random.default_rng(1)
    port._rng = np.random.default_rng(1)

    want_m = _update(jl, data)
    got_m = _update(port, data)
    want = state_from_jax(_np(jl.get_state()))
    got = port.get_state()
    assert got["opt_state"]["count"] == want["opt_state"]["count"] > \
        state_from_jax(carried)["opt_state"]["count"]
    for key in ("params", "target"):
        if key in want:
            _close(got[key], want[key], key)
    _close(got["opt_state"]["mu"], want["opt_state"]["mu"], "mu")
    _close(got["opt_state"]["nu"], want["opt_state"]["nu"], "nu")
    assert got.get("updates") == want.get("updates")
    assert got_m.keys() == want_m.keys()
    for k, w in want_m.items():
        np.testing.assert_allclose(got_m[k], w, rtol=METRIC_TOL,
                                   atol=METRIC_TOL, err_msg=k)


def test_plain_bc_gives_the_value_head_zero_gradients_as_jax_does():
    """Plain BC's loss reaches the value head through 0 * value: its Adam
    moments stay zero and its params unchanged, in both packages."""
    rng = np.random.default_rng(6)
    cfg = JaxBCConfig().training(**BC_TRAINING).learner_config_dict()
    port = BCLearner(SPEC, cfg, seed=0, device="cpu")
    before = {k: v.clone() for k, v in port.get_state()["params"].items()}
    port.update_offline(_bc_corpus(rng))
    state = port.get_state()
    for k, v in state["params"].items():
        if k.startswith("vf."):
            assert torch.equal(v, before[k]), k
            assert not state["opt_state"]["nu"][k].any(), k
        else:
            assert not torch.equal(v, before[k]), k


# ------------------------------------------------------------ evaluation --
def _recording(greedy, head, log):
    """``greedy`` that records each step's action and, on the port's
    side, the gap between the two outputs of the net's head ``head``."""
    def fn(params, obs):
        a = greedy(params, obs)
        if head is not None:
            out = getattr(params, head)(obs)[0]
            log.append((int(a[0]), float((out[0] - out[1]).abs())))
        else:
            log.append((int(np.asarray(a)[0]), None))
        return a
    return fn


def _jax_bc_greedy(algo):
    from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec
    module = JaxSpec(**algo._module_spec_kwargs(algo.config)).build()
    return jax.jit(module.forward_inference)


EVAL_ALGOS = {
    "bc": (JaxBCConfig, BCConfig, "pi",
           dict(lr=2e-3, num_epochs=2, minibatch_size=256)),
    "cql": (JaxCQLConfig, CQLConfig, "q1",
            dict(lr=1e-3, num_updates_per_iteration=100)),
    "iql": (JaxIQLConfig, IQLConfig, "pi",
            dict(lr=1e-3, expectile=0.8, num_updates_per_iteration=100)),
}


@pytest.mark.parametrize("name", sorted(EVAL_ALGOS))
def test_evaluate_from_carried_weights_equals_jax(name):
    """Two JAX iterations, their learner state carried into the port;
    three greedy episodes: the same action at every step, hence the same
    per-episode returns, and evaluate()'s mean equal."""
    jax_config, config, head, training = EVAL_ALGOS[name]
    # 20 episodes and two iterations: CQL's twin Q values lie close
    # together, and this corpus keeps its smallest gap above MIN_GAP.
    episodes = (scripted_cartpole_episodes(20) if name == "bc"
                else record_cartpole(20)[0])
    jalgo = (jax_config().environment("CartPole-v1").offline(episodes)
             .training(**training).debugging(seed=0).build_algo())
    algo = (config().environment("CartPole-v1").offline(episodes)
            .training(**training).resources(device="cpu")
            .debugging(seed=0).build_algo())
    try:
        for _ in range(2):
            jalgo.train()
        algo.learner_group.set_state(state_from_jax(
            _np(jalgo.learner_group.get_state())))
        weights = algo.learner_group.get_weights()
        jparams = jalgo.learner_group.get_weights()
        jgreedy = (_jax_bc_greedy(jalgo) if name == "bc"
                   else jax.jit(jalgo.learner_class.greedy_fn()))
        if name == "bc":
            net = RLModuleSpec(**SPEC).build(device="cpu")
            net.set_weights(weights)
            pgreedy = RLModule.forward_inference
        else:
            net = algo.learner_class.net_class(RLModuleSpec(**SPEC))
            net.load_state_dict(weights)
            pgreedy = algo.learner_class.greedy_fn()
        jlog, plog = [], []
        want = jax_greedy_rollout("CartPole-v1",
                                  _recording(jgreedy, None, jlog),
                                  jparams, 3)
        got = greedy_rollout("CartPole-v1", _recording(pgreedy, head, plog),
                             net, 3)
        assert [a for a, _ in plog] == [a for a, _ in jlog]
        assert got == want
        assert min(g for _, g in plog) >= MIN_GAP
        assert len(plog) > 3 * 30       # the policy balances a while
        assert algo.evaluate(3) == jalgo.evaluate(3) == want
    finally:
        jalgo.stop()
        algo.stop()


# ---------------------------------------------------------------- gates --
def _offline(config, episodes, **training):
    return (config().environment("CartPole-v1").offline(episodes)
            .training(**training).resources(device="cpu")
            .debugging(seed=0).build_algo())


def test_bc_imitates_scripted_policy():
    """tests/test_rllib_sac_offline.py:188-206 on the port."""
    algo = _offline(BCConfig, scripted_cartpole_episodes(), lr=2e-3,
                    num_epochs=4, minibatch_size=256)
    try:
        for _ in range(15):
            m = algo.train()
        assert np.isfinite(m["policy_loss"])
        ev = algo.evaluate(num_episodes=5)
        assert ev["episode_return_mean"] >= 100, ev
    finally:
        algo.stop()


def test_marwil_upweights_good_episodes():
    """tests/test_rllib_sac_offline.py:209-247 on the port."""
    episodes = (scripted_cartpole_episodes(n_episodes=25)
                + random_cartpole_episodes())
    algo = _offline(MARWILConfig, episodes, lr=2e-3, num_epochs=4,
                    minibatch_size=256, beta=2.0)
    try:
        for _ in range(15):
            m = algo.train()
        assert np.isfinite(m["vf_loss"]) and m["vf_loss"] > 0
        ev = algo.evaluate(num_episodes=5)
        assert ev["episode_return_mean"] >= 80, ev
    finally:
        algo.stop()


@pytest.mark.parametrize("name", ["cql", "iql"])
def test_learns_from_mixed_data(name):
    """tests/test_rllib_cql_iql.py:66-109 on the port: the greedy policy
    beats the behaviour's mean return by 20."""
    if name == "cql":
        episodes, behavior = record_cartpole()
        algo = _offline(CQLConfig, episodes, lr=1e-3, cql_alpha=1.0,
                        num_updates_per_iteration=100)
    else:
        episodes, behavior = record_cartpole(seed=7)
        algo = _offline(IQLConfig, episodes, lr=1e-3, expectile=0.8,
                        beta=3.0, num_updates_per_iteration=100)
    try:
        for _ in range(8):
            m = algo.train()
        assert np.isfinite(m["total_loss"]) and m["num_updates"] == 800
        if name == "cql":
            assert m["conservative_gap"] > 0.0
        ev = algo.evaluate(num_episodes=5)
        assert ev["episode_return_mean"] >= behavior + 20, (ev, behavior)
    finally:
        algo.stop()


def test_iql_expectile_raises_value_toward_max():
    """tests/test_rllib_cql_iql.py:112 on the port: with a higher
    expectile, V(s) regresses toward the upper tail of Q(s, a_data)."""
    spec = {"obs_dim": 3, "num_actions": 2, "hiddens": (16,)}
    rng = np.random.default_rng(0)
    batch = {"obs": torch.from_numpy(
                 rng.normal(size=(512, 3)).astype(np.float32)),
             "next_obs": torch.from_numpy(
                 rng.normal(size=(512, 3)).astype(np.float32)),
             "actions": torch.from_numpy(rng.integers(0, 2, 512)),
             "rewards": torch.from_numpy(
                 rng.normal(size=512).astype(np.float32)),
             "dones": torch.zeros(512)}

    def final_v(expectile):
        ln = IQLLearner(spec, {"expectile": expectile, "lr": 1e-2}, seed=0,
                        device="cpu")
        for _ in range(150):
            ln.update_transitions(batch)
        with torch.no_grad():
            return float(ln.net.v(batch["obs"]).mean())

    assert final_v(0.9) > final_v(0.1) + 0.05


# ------------------------------------------------------------ algorithm --
@pytest.mark.parametrize("config", [BCConfig, CQLConfig],
                         ids=["bc", "cql"])
def test_a_remote_learner_equals_a_local_one(config):
    """num_learners=1 (the learner an actor of LocalRuntime, the corpus
    put once) gives the local learner's state bit for bit."""
    episodes = record_cartpole(6)[0]
    states = []
    for n in (0, 1):
        algo = (config().environment("CartPole-v1").offline(episodes)
                .training(num_updates_per_iteration=8)
                .learners(num_learners=n).resources(device="cpu")
                .debugging(seed=3).build_algo())
        try:
            assert algo.learner_group.is_remote == bool(n)
            metrics = [algo.train() for _ in range(2)]
            states.append((algo.learner_group.get_state(), metrics))
        finally:
            algo.stop()
    (local, m0), (remote, m1) = states
    np.testing.assert_equal(m0, m1)     # NaN returns: no episodes
    for key in ("params", "target"):
        for k, v in local.get(key, {}).items():
            assert torch.equal(remote[key][k], v), (key, k)


class _Dataset:
    """A dataset of episode rows: only ``take_all``, as the reference
    recognises one."""

    def __init__(self, episodes):
        self._episodes = episodes

    def take_all(self):
        return list(self._episodes)


@pytest.mark.parametrize("wrap", ["take_all", "generator"])
def test_offline_data_from_a_dataset_or_a_generator(wrap):
    episodes = record_cartpole(4)[0]
    data = (_Dataset(episodes) if wrap == "take_all"
            else (ep for ep in episodes))
    algo = _offline(CQLConfig, data, num_updates_per_iteration=2)
    try:
        want = episodes_to_transitions(episodes)
        for k, v in want.items():
            np.testing.assert_array_equal(algo._transitions[k], v)
        assert algo.train()["num_updates"] == 2
    finally:
        algo.stop()


def test_entry_points_default_to_the_card():
    config = BCConfig().environment("CartPole-v1").offline(
        scripted_cartpole_episodes(2))
    assert config.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default works there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.build_algo()
    with pytest.raises(ValueError, match="offline"):
        BCConfig().environment("CartPole-v1").resources(
            device="cpu").build_algo()
