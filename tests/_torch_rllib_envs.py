"""Environments and recorded corpora shared by the port's rllib tests
(tests/test_torch_rllib_offline.py, tests/test_torch_rllib_multi_agent.py):
the JAX tests' CartPole recorders and their two-CartPole MultiAgentEnv,
over the port's CartPole. It imports neither JAX nor ray_tpu, so its env
classes can go to ray_tpu actors by value."""

import numpy as np

from ray_tpu_torch.rllib import MultiAgentEnv, envs


def scripted_cartpole_episodes(n_episodes=40, seed=0):
    """tests/test_rllib_sac_offline.py's scripted policy (pole angle +
    velocity feedback), at most 200 steps an episode."""
    env = envs.make("CartPole-v1")
    episodes = []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        rows_o, rows_a, rows_r = [], [], []
        done = False
        while not done and len(rows_a) < 200:
            a = int(obs[2] + 0.3 * obs[3] > 0)
            rows_o.append(obs.astype(np.float32))
            rows_a.append(a)
            obs, r, term, trunc, _ = env.step(a)
            rows_r.append(float(r))
            done = term or trunc
        episodes.append({"obs": np.stack(rows_o),
                         "actions": np.asarray(rows_a, np.int64),
                         "rewards": np.asarray(rows_r, np.float32)})
    env.close()
    return episodes


def random_cartpole_episodes(n_episodes=25, seed=500):
    """The uniformly random half of MARWIL's corpus
    (tests/test_rllib_sac_offline.py:213-231)."""
    rng = np.random.default_rng(0)
    env = envs.make("CartPole-v1")
    bad = []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        rows_o, rows_a, rows_r = [], [], []
        done = False
        while not done:
            a = int(rng.integers(0, 2))
            rows_o.append(obs.astype(np.float32))
            rows_a.append(a)
            obs, r, term, trunc, _ = env.step(a)
            rows_r.append(float(r))
            done = term or trunc
        bad.append({"obs": np.stack(rows_o),
                    "actions": np.asarray(rows_a, np.int64),
                    "rewards": np.asarray(rows_r, np.float32)})
    env.close()
    return bad


def record_cartpole(n_episodes=30, p_random=0.3, seed=0, horizon=200):
    """tests/test_rllib_cql_iql.py's mixed-quality corpus: the scripted
    policy with per-step epsilon-random corruption; (episodes, the
    behaviour's mean return)."""
    rng = np.random.default_rng(seed)
    env = envs.make("CartPole-v1")
    episodes, returns = [], []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        rows_o, rows_a, rows_r = [], [], []
        done = term = False
        while not done and len(rows_a) < horizon:
            if rng.random() < p_random:
                a = int(rng.integers(2))
            else:
                a = int(obs[2] + 0.3 * obs[3] > 0)
            rows_o.append(obs.astype(np.float32))
            rows_a.append(a)
            obs, r, term, trunc, _ = env.step(a)
            rows_r.append(float(r))
            done = term or trunc
        episodes.append({"obs": np.stack(rows_o),
                         "actions": np.asarray(rows_a, np.int64),
                         "rewards": np.asarray(rows_r, np.float32),
                         "terminated": bool(term)})
        returns.append(float(np.sum(rows_r)))
    env.close()
    return episodes, float(np.mean(returns))


class TwoCartPoles(MultiAgentEnv):
    """Two independent CartPole instances as one multi-agent env
    (tests/test_rllib_multi_agent.py:22-56 over the port's CartPole): the
    episode ends ('__all__') when either pole falls or time truncates."""

    agents = ["a0", "a1"]

    def __init__(self, time_limit=None):
        self._envs = {a: envs.make("CartPole-v1") for a in self.agents}
        for e in self._envs.values():
            if time_limit:
                e.max_episode_steps = time_limit
        self.observation_spaces = {
            a: e.observation_space for a, e in self._envs.items()}
        self.action_spaces = {
            a: e.action_space for a, e in self._envs.items()}

    def reset(self, seed=None):
        obs = {}
        for i, (a, e) in enumerate(self._envs.items()):
            obs[a], _ = e.reset(seed=None if seed is None else seed + i)
        return obs, {}

    def step(self, action_dict):
        obs, rew, term, trunc = {}, {}, {}, {}
        any_term, any_trunc = False, False
        for a, e in self._envs.items():
            obs[a], rew[a], t, tr, _ = e.step(action_dict[a])
            term[a], trunc[a] = t, tr
            any_term |= t
            any_trunc |= tr
        term["__all__"] = any_term
        trunc["__all__"] = any_trunc and not any_term
        return obs, rew, term, trunc, {}
