"""ray_tpu_torch.rllib's multi-agent path on the CPU, against the JAX
package.

The runner is compared whole with the JAX package's plain runner class
(``MultiAgentEnvRunner._cls``) on one MultiAgentEnv under decisive
weights (no Gumbel draw flips an action), with a 9-step time limit so the
truncation bootstrap runs. Then the reference's own tests
(tests/test_rllib_multi_agent.py) run on the port through
``LocalRuntime``, every refusal of ``Algorithm._init_multi_agent`` is
checked, and PPO trains once more with its runners and learners hosted as
``ray_tpu`` actors.
"""

import functools
import math
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import _torch_rllib_envs
from _torch_rllib_envs import TwoCartPoles
from _torch_rllib_helpers import SPEC, RayTpuRuntime, jax_params, same
from ray_tpu.rllib.multi_agent import (MultiAgentEnvRunner as
                                       JaxMultiAgentEnvRunner)
from ray_tpu_torch.rllib import (DQNConfig, Learner, LocalRuntime,
                                 MultiAgentEnvRunner, NormalizeObs,
                                 PPOConfig, envs)
from ray_tpu_torch.rllib.rl_module import state_dict_from_jax

# ray_tpu's workers do not carry tests/ on their path: ship the env
# classes by value.
cloudpickle.register_pickle_by_value(_torch_rllib_envs)
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class WideSecondAgent(TwoCartPoles):
    """a1 sees 5 observations: its spaces disagree with a0's."""

    def __init__(self):
        super().__init__()
        self.observation_spaces["a1"] = envs.Box(-np.ones(5), np.ones(5))


MAPPINGS = {"independent": ({"a0": "p0", "a1": "p1"}, (1, 2)),
            "shared": ({"a0": "shared", "a1": "shared"}, (3,))}


@pytest.mark.parametrize("mapping", sorted(MAPPINGS))
def test_sample_equals_jax_under_decisive_weights(mapping):
    """Two sample() calls of 25 steps, 3 envs, time limit 9: obs, actions,
    rewards, dones, final obs and episode returns exactly; logp, values,
    the truncation bonus and the bootstrap values at VALUE_TOL."""
    agent_to_policy, seeds = MAPPINGS[mapping]
    policies = sorted(set(agent_to_policy.values()))
    specs = {p: dict(SPEC) for p in policies}
    params = {p: jax_params(s, decisive=True)
              for p, s in zip(policies, seeds)}
    maker = functools.partial(TwoCartPoles, time_limit=9)
    ref = JaxMultiAgentEnvRunner._cls(maker, specs, agent_to_policy, 3, 11)
    mine = MultiAgentEnvRunner(maker, specs, agent_to_policy, 3, 11,
                               device="cpu")
    weights = {p: state_dict_from_jax(w) for p, w in params.items()}
    bonus = {p: 0 for p in policies}
    for _ in range(2):
        want = ref.sample(params, 25)
        got = mine.sample(weights, 25)
        assert got.keys() == want.keys()
        assert got["episode_returns"] == want["episode_returns"]
        assert want["episode_returns"]
        for p in policies:
            same(got[p], want[p], close=("logp", "vf", "trunc_bonus",
                                         "bootstrap_value"))
            n_cols = 3 * sum(v == p for v in agent_to_policy.values())
            assert got[p]["obs"].shape == (25, n_cols, 4)
            bonus[p] += np.count_nonzero(want[p]["trunc_bonus"])
    assert all(bonus.values()), bonus


def _cfg(mapping_fn, policies):
    return (PPOConfig()
            .environment(TwoCartPoles)
            .multi_agent(policies=policies, policy_mapping_fn=mapping_fn)
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(lr=5e-3, minibatch_size=64, num_epochs=2)
            .resources(device="cpu").debugging(seed=7))


def _independent(a):
    return {"a0": "p0", "a1": "p1"}[a]


def test_independent_policies_train(tmp_path):
    """tests/test_rllib_multi_agent.py:43-83 on the port, the round trip
    through save/restore bit-equal."""
    algo = _cfg(_independent, ["p0", "p1"]).build_algo()
    try:
        assert isinstance(algo._rt, LocalRuntime)
        w0 = {p: lg.get_weights() for p, lg in algo.learner_groups.items()}
        results = [algo.train() for _ in range(3)]
        for r in results:
            for p in ("p0", "p1"):
                assert np.isfinite(r[f"{p}/total_loss"]), r
                assert r[f"{p}/num_samples"] == 32 * 4
        assert results[-1]["num_episodes"] > 0
        assert np.isfinite(results[-1]["episode_return_mean"])
        for p in ("p0", "p1"):
            after = algo.learner_groups[p].get_weights()
            assert any(not torch.equal(after[k], v)
                       for k, v in w0[p].items()), p
        algo.save(str(tmp_path))
        algo2 = _cfg(_independent, ["p0", "p1"]).build_algo()
        try:
            algo2.restore(str(tmp_path))
            assert algo2.iteration == algo.iteration == 3
            for p in ("p0", "p1"):
                got = algo2.learner_groups[p].get_state()
                want = algo.learner_groups[p].get_state()
                assert got["opt_state"]["count"] == \
                    want["opt_state"]["count"]
                for k, v in want["params"].items():
                    assert torch.equal(got["params"][k], v), (p, k)
                for k, v in want["opt_state"]["nu"].items():
                    assert torch.equal(got["opt_state"]["nu"][k], v)
        finally:
            algo2.stop()
    finally:
        algo.stop()


def test_policy_learners_are_seeded_in_sorted_order():
    """One LearnerGroup per policy, seeded config.seed + i over the sorted
    policy ids (reference: algorithm.py:227-233)."""
    algo = _cfg(_independent, ["p1", "p0"]).build_algo()
    try:
        cfg = algo.config.learner_config_dict()
        for i, p in enumerate(["p0", "p1"]):
            want = Learner(dict(SPEC), cfg, 7 + i, "cpu").get_weights()
            got = algo.learner_groups[p].get_weights()
            for k, v in want.items():
                assert torch.equal(got[k], v), (p, k)
        runner = algo.env_runner_group.runners[0].instance
        assert runner.policy_agents == {"p0": ["a0"], "p1": ["a1"]}
    finally:
        algo.stop()


def test_shared_policy_batches_all_agents():
    """Both agents mapped to ONE policy: its batch carries both agents as
    columns (N = num_envs * 2)."""
    algo = _cfg(lambda a: "shared", ["shared"]).build_algo()
    try:
        r = algo.train()
        assert np.isfinite(r["shared/total_loss"])
        assert set(algo.learner_groups) == {"shared"}
        assert r["shared/num_samples"] == 32 * 4 * 2
        runner = algo.env_runner_group.runners[0].instance
        batch = runner.sample(
            {"shared": algo.learner_groups["shared"].get_weights()}, 5)
        assert batch["shared"]["obs"].shape == (5, 4 * 2, 4)
    finally:
        algo.stop()


def test_multi_agent_validation():
    """tests/test_rllib_multi_agent.py:86-95 on the port."""
    with pytest.raises(ValueError, match="callable"):
        (PPOConfig().environment("CartPole-v1")
         .multi_agent(policies=["p"], policy_mapping_fn=lambda a: "p")
         .resources(device="cpu").build_algo())
    with pytest.raises(ValueError, match="unknown policies"):
        (PPOConfig().environment(TwoCartPoles)
         .multi_agent(policies=["p0"],
                      policy_mapping_fn=lambda a: "nope")
         .resources(device="cpu").build_algo())


REFUSALS = {
    "training_step_override": (
        lambda: DQNConfig().environment(TwoCartPoles).multi_agent(
            policies=["p"], policy_mapping_fn=lambda a: "p"),
        NotImplementedError, "DQN does not support multi_agent"),
    "env_to_module": (
        lambda: PPOConfig().environment(TwoCartPoles).env_runners(
            env_to_module=NormalizeObs()).multi_agent(
            policies=["p"], policy_mapping_fn=lambda a: "p"),
        NotImplementedError, "env_to_module connectors are not supported"),
    "string_env": (
        lambda: PPOConfig().environment("CartPole-v1").multi_agent(
            policies=["p"], policy_mapping_fn=lambda a: "p"),
        ValueError, "needs environment"),
    "unknown_policy": (
        lambda: PPOConfig().environment(TwoCartPoles).multi_agent(
            policies=["p0"], policy_mapping_fn=lambda a: "nope"),
        ValueError, "produced unknown policies"),
    "unmapped_policy": (
        lambda: PPOConfig().environment(TwoCartPoles).multi_agent(
            policies=["p0", "p1"], policy_mapping_fn=lambda a: "p0"),
        ValueError, r"policies \['p1'\] are declared"),
    "spaces_disagree": (
        lambda: PPOConfig().environment(WideSecondAgent).multi_agent(
            policies=["p"], policy_mapping_fn=lambda a: "p"),
        ValueError, "disagree on observation/action spaces"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_multi_agent_refusals(name):
    make, exc, match = REFUSALS[name]
    with pytest.raises(exc, match=match):
        make().resources(device="cpu").build_algo()


def test_episode_returns_is_a_reserved_policy_id():
    with pytest.raises(ValueError, match="reserved"):
        PPOConfig().multi_agent(policies=["episode_returns"],
                                policy_mapping_fn=lambda a: "x")
    config = PPOConfig().multi_agent(policies={"p": {}},
                                     policy_mapping_fn=_independent)
    assert config.policies == {"p": {}}
    assert config.policy_mapping_fn is _independent


def test_ppo_multi_agent_under_the_ray_tpu_runtime(ray_start_regular):
    algo = (_cfg(_independent, ["p0", "p1"]).learners(num_learners=1)
            .build_algo(runtime=RayTpuRuntime()))
    try:
        runners = algo.env_runner_group.runners
        assert all(type(r).__module__.startswith("ray_tpu.")
                   for r in runners)
        assert all(lg.is_remote for lg in algo.learner_groups.values())
        for _ in range(2):
            m = algo.train()
        assert m["training_iteration"] == 2
        for p in ("p0", "p1"):
            assert m[f"{p}/num_samples"] == 32 * 4
            assert math.isfinite(m[f"{p}/total_loss"])
    finally:
        algo.stop()
