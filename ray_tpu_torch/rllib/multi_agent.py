"""Multi-agent RL: MultiAgentEnv + per-policy sampling and training.

Port of ray_tpu/rllib/multi_agent.py (reference surface:
python/ray/rllib/env/multi_agent_env.py (MultiAgentEnv — dict
obs/action/reward/termination per agent, "__all__" episode end),
env/multi_agent_env_runner.py (sampling), and the multi_agent() config
section (policies + policy_mapping_fn) routing each agent's experience to
its policy's module/learner (algorithm_config.py multi_agent()).

Simultaneous-action envs with a FIXED agent set map onto the same
[T, N, ...] column-parallel batch layout the single-agent stack uses: each
policy's batch carries its agents as extra columns (N = num_envs x
agents_of_policy), so the PPO learner updates each policy unchanged, and
policies train as independent LearnerGroups. Each policy's module lives on
the runner's device; each step one copy takes a policy's observations
there and one brings its actions, logp and values back. Turn-based or
dynamic agent sets are out of scope, as in the reference.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ._runtime import LocalRuntime
from .rl_module import RLModuleSpec


class MultiAgentEnv(abc.ABC):
    """Env contract (reference: multi_agent_env.py MultiAgentEnv).

    Subclasses define:
      - agents: List[str] — FIXED agent ids, all acting every step
      - observation_spaces / action_spaces: Dict[agent_id, space] (a
        space with ``shape``, one with ``n``: ``envs.Box`` /
        ``envs.Discrete``)
      - reset(seed=None) -> (obs_dict, info)
      - step(action_dict) -> (obs_dict, rew_dict, terminated_dict,
        truncated_dict, info); terminated/truncated carry "__all__"
    """

    agents: List[str] = []
    observation_spaces: Dict[str, Any] = {}
    action_spaces: Dict[str, Any] = {}

    @abc.abstractmethod
    def reset(self, seed: Optional[int] = None):
        """-> (obs_dict, info)."""

    @abc.abstractmethod
    def step(self, action_dict: Dict[str, Any]):
        """-> (obs_dict, rew_dict, terminated_dict, truncated_dict,
        info)."""


class _MultiVec:
    """num_envs copies of a MultiAgentEnv stepped lockstep with
    auto-reset on '__all__' (the multi-agent analogue of _VecEnv)."""

    def __init__(self, env_maker: Callable[[], MultiAgentEnv],
                 num_envs: int, seed: int):
        self.envs = [env_maker() for _ in range(num_envs)]
        self.agents = list(self.envs[0].agents)
        self.obs = [e.reset(seed=seed + i)[0]
                    for i, e in enumerate(self.envs)]
        self._ep_ret = np.zeros(num_envs)
        self.completed_returns: List[float] = []

    def step(self, actions: List[Dict[str, Any]]):
        """actions[i] is env i's action dict.  Returns per-env obs dicts,
        reward dicts, done flags (episode end), trunc flags, final obs."""
        obs_out, rew_out = [], []
        dones = np.zeros(len(self.envs), bool)
        truncs = np.zeros(len(self.envs), bool)
        final_obs: List[Optional[dict]] = [None] * len(self.envs)
        for i, (env, act) in enumerate(zip(self.envs, actions)):
            obs, rew, term, trunc, _ = env.step(act)
            self._ep_ret[i] += sum(rew.values())
            done = bool(term.get("__all__")) or bool(trunc.get("__all__"))
            if done:
                if trunc.get("__all__") and not term.get("__all__"):
                    truncs[i] = True
                    final_obs[i] = obs
                self.completed_returns.append(float(self._ep_ret[i]))
                self._ep_ret[i] = 0.0
                obs, _ = env.reset()
                dones[i] = True
            obs_out.append(obs)
            rew_out.append(rew)
        self.obs = obs_out
        return obs_out, rew_out, dones, truncs, final_obs

    def drain_returns(self) -> List[float]:
        out, self.completed_returns = self.completed_returns, []
        return out


class MultiAgentEnvRunner:
    """Multi-agent sampler (reference: multi_agent_env_runner.py), made
    an actor by the runtime.

    Per policy: one module on the runner's device; per step, each policy
    batches the observations of ITS agents across all envs into one
    forward pass. Actions are sampled with the runner's one
    ``torch.Generator``, policy after policy. sample() returns
    {policy_id: single-agent-shaped batch} — columns are (env, agent)
    pairs in a fixed order, so GAE in the learner sees correctly chained
    per-column episodes."""

    def __init__(self, env_maker, policy_specs: Dict[str, dict],
                 agent_to_policy: Dict[str, str], num_envs: int,
                 seed: int, gamma: float = 0.99,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.vec = _MultiVec(env_maker, num_envs, seed)
        self.agent_to_policy = dict(agent_to_policy)
        self.num_envs = num_envs
        self.gamma = gamma
        # policy -> its agents, in fixed agent order (column layout).
        self.policy_agents: Dict[str, List[str]] = {}
        for a in self.vec.agents:
            self.policy_agents.setdefault(self.agent_to_policy[a],
                                          []).append(a)
        self.modules = {p: RLModuleSpec(**kw).build(seed, self.device)
                        for p, kw in policy_specs.items()}
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _policy_obs(self, obs_dicts: List[dict], policy: str) -> np.ndarray:
        """[num_envs * n_agents, obs_dim]: env-major, agent-minor —
        matches the column layout of every other field."""
        rows = [np.asarray(od[a], np.float32)
                for od in obs_dicts for a in self.policy_agents[policy]]
        return np.stack(rows)

    def _on_device(self, obs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(obs).to(self.device)

    def _value(self, policy: str, obs: np.ndarray) -> np.ndarray:
        return self.modules[policy].logits_and_value(
            self._on_device(obs))[1].cpu().numpy()

    @torch.no_grad()
    def sample(self, weights: Dict[str, Any], rollout_len: int
               ) -> Dict[str, Any]:
        for p, mod in self.modules.items():
            mod.set_weights(weights[p])
        out = {p: {"obs": [], "actions": [], "logp": [], "vf": [],
                   "rewards": [], "trunc_bonus": [], "dones": []}
               for p in self.modules}
        for _ in range(rollout_len):
            obs_dicts = self.vec.obs
            acts_per_env: List[Dict[str, Any]] = [
                {} for _ in range(self.num_envs)]
            step_rec = {}
            for p, mod in self.modules.items():
                t_obs = self._policy_obs(obs_dicts, p)
                actions, logp, value = mod.forward_exploration(
                    self._on_device(t_obs), self.gen)
                # One copy back: actions (small ints, exact in f32), logp,
                # value.
                res = torch.stack([actions.float(), logp, value]
                                  ).cpu().numpy()
                actions = res[0].astype(np.int32)
                step_rec[p] = (t_obs, actions, res[1], res[2])
                k = 0
                for i in range(self.num_envs):
                    for a in self.policy_agents[p]:
                        acts_per_env[i][a] = int(actions[k])
                        k += 1
            obs_dicts, rew_dicts, dones, truncs, final_obs = \
                self.vec.step(acts_per_env)
            for p in self.modules:
                t_obs, actions, logp, value = step_rec[p]
                rewards = np.asarray(
                    [rew_dicts[i][a] for i in range(self.num_envs)
                     for a in self.policy_agents[p]], np.float32)
                pdones = np.repeat(dones, len(self.policy_agents[p]))
                bonus = np.zeros_like(rewards)
                if truncs.any():
                    # Time-limit bootstrap per truncated env, per policy.
                    fin_rows, idxs = [], []
                    k = 0
                    for i in range(self.num_envs):
                        for a in self.policy_agents[p]:
                            if truncs[i]:
                                fin_rows.append(np.asarray(
                                    final_obs[i][a], np.float32))
                                idxs.append(k)
                            k += 1
                    v_fin = self._value(p, np.stack(fin_rows))
                    bonus[np.asarray(idxs)] = self.gamma * v_fin
                rec = out[p]
                rec["obs"].append(t_obs)
                rec["actions"].append(actions)
                rec["logp"].append(logp)
                rec["vf"].append(value)
                rec["rewards"].append(rewards)
                rec["trunc_bonus"].append(bonus)
                rec["dones"].append(pdones)
        batches: Dict[str, Any] = {}
        for p in self.modules:
            final_t = self._policy_obs(self.vec.obs, p)
            batches[p] = {k: np.stack(v) for k, v in out[p].items()}
            batches[p]["bootstrap_value"] = self._value(p, final_t)
            batches[p]["final_obs"] = final_t
        batches["episode_returns"] = self.vec.drain_returns()
        return batches


class MultiAgentEnvRunnerGroup:
    """Fan-out over MultiAgentEnvRunner actors of ``runtime`` (reference:
    env_runner_group.py with multi-agent runners)."""

    def __init__(self, *, env_maker, policy_specs, agent_to_policy,
                 num_env_runners: int, num_envs_per_runner: int,
                 seed: int, gamma: float, runner_resources=None,
                 device: Union[str, torch.device] = "cuda", runtime=None):
        self._rt = runtime or LocalRuntime()
        res = dict(runner_resources or {})
        self.runners = [
            self._rt.remote(MultiAgentEnvRunner,
                            num_cpus=res.get("num_cpus", 1),
                            resources=res.get("resources"))(
                env_maker, policy_specs, agent_to_policy,
                num_envs_per_runner, seed + 1000 * i, gamma, device)
            for i in range(num_env_runners)]

    def sample(self, weights_ref, rollout_len: int) -> List[Dict[str, Any]]:
        return self._rt.get(
            [r.sample.remote(weights_ref, rollout_len)
             for r in self.runners], timeout=300)

    def stop(self):
        for r in self.runners:
            self._rt.kill(r)
