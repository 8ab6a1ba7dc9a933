"""ray_tpu_torch.rllib's runners and algorithms on the CPU.

The JAX package's EnvRunner is an actor class; its plain class
(``EnvRunner._cls``) runs in this process, without ``ray_tpu.init``.
Action sampling draws from different streams in the two packages, so the
runners are compared whole where the policy is deterministic: epsilon
draws (numpy in both) around greedy actions, and policies whose logits are
so far apart that no Gumbel draw can flip them ("decisive" weights).
Then every algorithm trains through ``LocalRuntime``, PPO until it learns
CartPole, and PPO once more with its runners as ``ray_tpu``
actors through an adapter of the runtime protocol (every wait bounded at
60 s), which shows that the port's Algorithm holds only the boundary.
"""

import math

import numpy as np
import pytest
import torch

from _torch_rllib_helpers import SPEC, RayTpuRuntime, jax_params, same
from ray_tpu.rllib.env_runner import EnvRunner as JaxEnvRunner
from ray_tpu_torch.rllib import (APPOConfig, DQNConfig, EnvRunner,
                                 IMPALAConfig, LocalRuntime, PPOConfig,
                                 SACConfig)
from ray_tpu_torch.rllib.rl_module import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runners(seed, time_limit=None):
    ref = JaxEnvRunner._cls("CartPole-v1", SPEC, 4, seed)
    mine = EnvRunner("CartPole-v1", SPEC, 4, seed, device="cpu")
    if time_limit:
        for e in ref.vec.envs:
            e._max_episode_steps = time_limit
        for e in mine.vec.envs:
            e.max_episode_steps = time_limit
    return ref, mine


@pytest.mark.parametrize("epsilon", [0.3, -1.0])
def test_sample_transitions_equal_jax(epsilon):
    """epsilon 0.3: greedy actions and numpy epsilon draws, from the same
    weights; epsilon < 0 (SAC's sampling from pi) with decisive
    weights. Two calls, so the runner's carried state is compared too."""
    params = jax_params(0, decisive=epsilon < 0)
    ref, mine = _runners(3, time_limit=30)
    for _ in range(2):
        want = ref.sample_transitions(params, 40, epsilon)
        got = mine.sample_transitions(state_dict_from_jax(params), 40,
                                      epsilon)
        same(got, want)
        assert want["episode_returns"]


def test_sample_equals_jax_under_a_decisive_policy():
    """The whole on-policy sample(), truncation bootstrap included (a
    time limit of 9 steps): observations, actions, rewards, dones and
    episode returns exactly; logp, values and the bonus at VALUE_TOL."""
    params = jax_params(1, decisive=True)
    ref, mine = _runners(5, time_limit=9)
    for _ in range(2):
        want = ref.sample(params, 25)
        got = mine.sample(state_dict_from_jax(params), 25)
        same(got, want, close=("logp", "vf", "trunc_bonus",
                               "bootstrap_value"))
        assert want["trunc_bonus"].any()


def _config(cls, **training):
    return (cls().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=16)
            .training(**training).resources(device="cpu")
            .debugging(seed=0))


ALGOS = {
    "ppo": (PPOConfig, {}),
    "impala": (IMPALAConfig, {}),
    "appo": (APPOConfig, {}),
    "dqn": (DQNConfig, dict(learning_starts=64,
                            num_updates_per_iteration=4)),
    "sac": (SACConfig, dict(learning_starts=64,
                            num_updates_per_iteration=4)),
}


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_algorithm_trains_two_iterations_on_the_cpu(name):
    cls, training = ALGOS[name]
    algo = _config(cls, **training).build_algo()
    try:
        assert isinstance(algo._rt, LocalRuntime)
        for i in range(2):
            m = algo.train()
            assert m["training_iteration"] == i + 1
        losses = [v for k, v in m.items() if k.endswith("_loss")]
        assert losses and all(math.isfinite(v) for v in losses)
        assert m["num_episodes"] > 0
        if name in ("dqn", "sac"):
            assert m["num_updates"] == 8
        state = algo.learner_group.get_state()
        for t in state["params"].values():
            assert t.device.type == "cpu" and torch.isfinite(t).all()
        runner = algo.env_runner_group.runners[0].instance
        assert runner.module.device.type == "cpu"
    finally:
        algo.stop()


def test_dqn_save_restore_keeps_target_net(tmp_path):
    algo = _config(DQNConfig, learning_starts=64,
                   num_updates_per_iteration=4,
                   target_network_update_freq=5).build_algo()
    try:
        for _ in range(3):
            algo.train()
        path = algo.save(str(tmp_path / "dqn"))
        state = algo.learner_group.get_state()
        assert state["updates"] == 12
        assert not all(torch.equal(state["target_params"][k], v)
                       for k, v in state["params"].items())
    finally:
        algo.stop()
    algo2 = _config(DQNConfig).debugging(seed=2).build_algo()
    try:
        algo2.restore(path)
        assert algo2.iteration == 3
        got = algo2.learner_group.get_state()
        assert got["updates"] == 12
        for key in ("params", "target_params"):
            for k, v in state[key].items():
                assert torch.equal(got[key][k], v), (key, k)
        for k, v in state["opt_state"]["nu"].items():
            assert torch.equal(got["opt_state"]["nu"][k], v)
        assert algo2.train()["training_iteration"] == 4
    finally:
        algo2.stop()


def test_ppo_learns_cartpole_on_the_cpu():
    """The JAX package's gate (tests/test_rllib.py): mean episode return
    120 within 35 iterations of 2 runners x 8 envs x 64 steps."""
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
            .training(lr=3e-4, entropy_coeff=0.01)
            .resources(device="cpu").debugging(seed=0).build_algo())
    try:
        best = 0.0
        for _ in range(35):
            best = max(best, algo.train()["episode_return_mean"])
            if best >= 120:
                break
        assert best >= 120, f"PPO failed to learn CartPole (best={best})"
    finally:
        algo.stop()


def test_ppo_under_the_ray_tpu_runtime(ray_start_regular):
    algo = _config(PPOConfig).build_algo(runtime=RayTpuRuntime())
    try:
        runners = algo.env_runner_group.runners
        assert all(type(r).__module__.startswith("ray_tpu.")
                   for r in runners)
        for i in range(2):
            m = algo.train()
        assert m["training_iteration"] == 2
        assert m["num_samples"] == 2 * 4 * 16
        assert math.isfinite(m["total_loss"]) and m["num_episodes"] > 0
    finally:
        algo.stop()
