"""Parity of ray_tpu_torch.rllib's numpy half with the JAX package and
gymnasium on the CPU.

The port ships its own CartPole-v1 (``ray_tpu_torch.rllib.envs``), which
must step as ``gymnasium.make("CartPole-v1")`` does, bit for bit, through
termination and the 500-step truncation; its ``_VecEnv`` must equal the
JAX package's, which runs gymnasium's. GAE, n-step folding, the
connectors and the replay buffers are numpy in both packages and must be
equal exactly. Nothing here needs JAX's runtime.
"""

import os
import subprocess
import sys

import gymnasium as gym
import numpy as np
import pytest

from ray_tpu.rllib import connectors as jax_connectors
from ray_tpu.rllib import replay_buffers as jax_replay
from ray_tpu.rllib.dqn import fold_nstep as jax_fold_nstep
from ray_tpu.rllib.env_runner import _VecEnv as JaxVecEnv
from ray_tpu.rllib.learner import compute_gae as jax_compute_gae
from ray_tpu_torch.rllib import connectors, envs, replay_buffers
from ray_tpu_torch.rllib.dqn import fold_nstep
from ray_tpu_torch.rllib.env_runner import _VecEnv
from ray_tpu_torch.rllib.learner import compute_gae

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def balance(obs) -> int:
    """A scripted controller that keeps the pole up for the whole 500
    steps (so episodes end by truncation)."""
    x, x_dot, theta, theta_dot = obs
    return int(theta + 0.5 * theta_dot + 0.01 * x + 0.1 * x_dot > 0)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", ["random", "balance"])
def test_cartpole_steps_as_gymnasium_bit_for_bit(policy):
    ref, mine = gym.make("CartPole-v1"), envs.make("CartPole-v1")
    rng = np.random.default_rng(7)
    truncations = terminations = 0
    for episode in range(4):
        # A seeded reset, then resets that continue the same generator.
        seed = 11 + episode if episode % 2 == 0 else None
        o_ref, _ = ref.reset(seed=seed)
        o_mine, _ = mine.reset(seed=seed)
        _equal(o_mine, o_ref)
        for _ in range(600):
            a = balance(o_ref) if policy == "balance" else int(
                rng.integers(2))
            o_ref, r_ref, term_ref, trunc_ref, _ = ref.step(a)
            o_mine, r_mine, term_mine, trunc_mine, _ = mine.step(a)
            _equal(o_mine, o_ref)
            np.testing.assert_array_equal(
                mine.unwrapped.state, ref.unwrapped.state)
            assert type(r_mine) is type(r_ref) and r_mine == r_ref
            assert (term_mine, trunc_mine) == (term_ref, trunc_ref)
            if term_ref or trunc_ref:
                truncations += trunc_ref
                terminations += term_ref
                break
    if policy == "balance":
        assert truncations == 4 and terminations == 0
    else:
        assert terminations == 4


def test_cartpole_spaces_and_registry():
    env = envs.make("CartPole-v1")
    ref = gym.make("CartPole-v1")
    assert env.observation_space.shape == (4,) == ref.observation_space.shape
    assert env.action_space.n == 2 == ref.action_space.n
    _equal(env.observation_space.high, ref.observation_space.high)
    assert env.max_episode_steps == ref.spec.max_episode_steps == 500
    with pytest.raises(ValueError, match="does not use gymnasium"):
        envs.make("Pendulum-v1")
    env.reset(seed=0)
    with pytest.raises(ValueError, match="invalid"):
        env.step(2)


def test_vec_env_matches_jax_through_truncation():
    """Four envs seeded 5..8, two balanced (truncated at 500 steps) and
    two random (terminating early), 1100 steps: obs, rewards, dones,
    truncations, final observations and episode returns equal."""
    jax_vec, vec = JaxVecEnv("CartPole-v1", 4, 5), _VecEnv("CartPole-v1", 4, 5)
    _equal(vec.obs, jax_vec.obs)
    rng = np.random.default_rng(0)
    n_trunc = 0
    for _ in range(1100):
        actions = np.array([balance(vec.obs[0]), balance(vec.obs[1]),
                            *rng.integers(0, 2, 2)])
        got = vec.step(actions)
        want = jax_vec.step(actions)
        for g, w in zip(got[:4], want[:4]):
            _equal(g, w)
        for g, w in zip(got[4], want[4]):
            assert (g is None) == (w is None)
            if g is not None:
                _equal(g, w)
        n_trunc += int(got[3].sum())
    assert n_trunc == 4                 # two balanced envs, twice each
    assert vec.drain_returns() == jax_vec.drain_returns()


def test_compute_gae_equals_jax_exactly():
    rng = np.random.default_rng(1)
    T, N = 33, 5
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.1
    boot = rng.normal(size=N).astype(np.float32)
    for g, w in zip(compute_gae(rewards, values, dones, boot, 0.99, 0.95),
                    jax_compute_gae(rewards, values, dones, boot, 0.99,
                                    0.95)):
        _equal(g, w)


@pytest.mark.parametrize("n_step", [1, 3])
def test_fold_nstep_equals_jax_exactly(n_step):
    rng = np.random.default_rng(2)
    T, N = 16, 3
    sample = {
        "obs": rng.normal(size=(T, N, 4)).astype(np.float32),
        "next_obs": rng.normal(size=(T, N, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": rng.random((T, N)) < 0.1,
    }
    sample["resets"] = sample["dones"] | (rng.random((T, N)) < 0.1)
    got, want = fold_nstep(sample, n_step, 0.97), jax_fold_nstep(
        sample, n_step, 0.97)
    assert got.keys() == want.keys()
    for k in got:
        _equal(got[k], want[k])


def _pipelines(mod):
    return mod.ConnectorPipeline(mod.FlattenObs(), mod.FrameStack(3),
                                 mod.NormalizeObs())


def test_connectors_equal_jax_exactly():
    rng = np.random.default_rng(3)
    mine, ref = _pipelines(connectors), _pipelines(jax_connectors)
    assert mine.transform_obs_dim(4) == ref.transform_obs_dim(4) == 12
    dones = None
    for _ in range(20):
        obs = rng.normal(size=(4, 2, 2)).astype(np.float32)
        _equal(mine.peek({"obs": obs.reshape(4, -1)})["obs"],
               ref.peek({"obs": obs.reshape(4, -1)})["obs"])
        _equal(mine({"obs": obs.copy()}, {"dones": dones})["obs"],
               ref({"obs": obs.copy()}, {"dones": dones})["obs"])
        dones = rng.random(4) < 0.3
    rewards = rng.normal(size=50).astype(np.float32) * 3
    _equal(connectors.ClipRewards(1.5)({"rewards": rewards})["rewards"],
           jax_connectors.ClipRewards(1.5)({"rewards": rewards})["rewards"])
    _equal(mine.stages[-1].get_state()["m2"], ref.stages[-1].get_state()["m2"])


def _transitions(rng, n):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": rng.random(n) < 0.1}


@pytest.mark.parametrize("kind", ["uniform", "prioritized", "episode"])
def test_replay_buffers_sample_as_jax_exactly(kind):
    rng = np.random.default_rng(4)
    if kind == "episode":
        mine = replay_buffers.EpisodeReplayBuffer(300, seed=9)
        ref = jax_replay.EpisodeReplayBuffer(300, seed=9)
    elif kind == "prioritized":
        mine = replay_buffers.PrioritizedReplayBuffer(200, 0.6, seed=9)
        ref = jax_replay.PrioritizedReplayBuffer(200, 0.6, seed=9)
    else:
        mine = replay_buffers.ReplayBuffer(200, seed=9)
        ref = jax_replay.ReplayBuffer(200, seed=9)
    for _ in range(8):
        batch = _transitions(rng, int(rng.integers(20, 90)))
        mine.add(batch)
        ref.add(batch)
        assert len(mine) == len(ref)
        got, want = mine.sample(32), ref.sample(32)
        assert got.keys() == want.keys()
        for k in got:
            _equal(got[k], want[k])
        if kind == "prioritized":
            td = rng.normal(size=32)
            mine.update_priorities(got["batch_indexes"], td)
            ref.update_priorities(want["batch_indexes"], td)
    if kind == "episode":
        assert mine.num_episodes == ref.num_episodes


def test_rllib_imports_no_jax_optax_gymnasium_or_ray_tpu():
    code = (
        "import sys\n"
        "import ray_tpu_torch.rllib\n"
        "from ray_tpu_torch.rllib import (_runtime, algorithm, appo,\n"
        "    connectors, cql, dqn, env_runner, envs, impala, iql, learner,\n"
        "    multi_agent, offline, ppo, replay_buffers, rl_module, sac)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
        "                                    'gymnasium', 'ray_tpu',\n"
        "                                    'cloudpickle'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
