"""EnvRunner: collects vectorized experience with the policy on a device.

Port of ray_tpu/rllib/env_runner.py (reference surface:
python/ray/rllib/env/single_agent_env_runner.py — an EnvRunner holds a
vector env plus an inference copy of the RLModule and produces sample
batches; env_runner_group.py fans sampling out over runner actors). The
environments are the port's own (``envs.make``). The runner's module lives
on its device: each step the whole [N, obs] batch goes there in one copy
and the actions (with their logp and value) come back in one.

Weights arrive as a state dict snapshot and are copied into the runner's
own module (``RLModule.set_weights``). Actions are sampled with the
runner's ``torch.Generator``, epsilon draws with its numpy generator, as
the reference's are.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from . import envs
from ._runtime import LocalRuntime
from .rl_module import RLModuleSpec


def _make_env(env_name: str, seed: int):
    env = envs.make(env_name)
    env.reset(seed=seed)
    return env


class _VecEnv:
    """N independent envs stepped lockstep with auto-reset
    (reference: gymnasium vector envs used by single_agent_env_runner)."""

    def __init__(self, env_name: str, num_envs: int, seed: int):
        self.envs = [_make_env(env_name, seed + i) for i in range(num_envs)]
        self.obs = np.stack([e.reset(seed=seed + i)[0]
                             for i, e in enumerate(self.envs)])
        # Per-env running episode returns, plus the returns of episodes
        # completed since the last drain (for metrics).
        self._ep_ret = np.zeros(num_envs)
        self.completed_returns: List[float] = []

    def step(self, actions: np.ndarray):
        next_obs, rewards, dones = [], [], []
        truncs = np.zeros(len(self.envs), bool)
        final_obs = [None] * len(self.envs)
        for i, (env, a) in enumerate(zip(self.envs, actions)):
            obs, r, term, trunc, _ = env.step(int(a))
            done = term or trunc
            self._ep_ret[i] += r
            if done:
                if trunc and not term:
                    # Time-limit cut, not a real terminal: hand the final
                    # observation back so the runner can bootstrap V(s_T)
                    # (reference: env runners bootstrap at truncations).
                    truncs[i] = True
                    final_obs[i] = obs
                self.completed_returns.append(float(self._ep_ret[i]))
                self._ep_ret[i] = 0.0
                obs, _ = env.reset()
            next_obs.append(obs)
            rewards.append(r)
            dones.append(done)
        self.obs = np.stack(next_obs)
        return (self.obs, np.array(rewards, np.float32), np.array(dones),
                truncs, final_obs)

    def drain_returns(self) -> List[float]:
        out, self.completed_returns = self.completed_returns, []
        return out


class EnvRunner:
    """One sampler (reference: SingleAgentEnvRunner), made an actor by
    the runtime.

    sample(weights, rollout_len) steps the vector env with the given
    policy weights and returns a flat batch of transitions + bootstrap
    values; GAE happens in the Learner so the runner stays policy-agnostic.
    """

    def __init__(self, env_name: str, spec_kwargs: Dict[str, Any],
                 num_envs: int, seed: int, gamma: float = 0.99,
                 env_to_module=None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.module = RLModuleSpec(**spec_kwargs).build(seed, self.device)
        self.vec = _VecEnv(env_name, num_envs, seed)
        self.gamma = gamma
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        # Env-to-module connector pipeline (reference: ConnectorV2):
        # observations are transformed BEFORE inference and the
        # TRANSFORMED arrays are what's recorded — module and learner
        # always see connector-space observations.
        self.e2m = env_to_module
        # Dones from the LAST step of the previous fragment: instance
        # state, so an episode ending on a fragment's final step still
        # resets stateful connectors at the next fragment's first step.
        self._last_dones = None

    def _obs_in(self, obs, dones=None) -> np.ndarray:
        if self.e2m is None:
            return obs.astype(np.float32)
        return self.e2m({"obs": obs}, {"dones": dones})["obs"]

    def _obs_peek(self, obs) -> np.ndarray:
        """Same-episode lookahead transform (bootstrap / next_obs reads):
        never advances connector state."""
        if self.e2m is None:
            return np.asarray(obs, np.float32)
        return self.e2m.peek({"obs": np.asarray(obs)})["obs"]

    def _on_device(self, obs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(obs, np.float32)).to(self.device)

    @torch.no_grad()
    def _value(self, obs: np.ndarray) -> np.ndarray:
        return self.module.logits_and_value(
            self._on_device(obs))[1].cpu().numpy()

    @torch.no_grad()
    def sample(self, weights, rollout_len: int) -> Dict[str, Any]:
        self.module.set_weights(weights)
        obs_l, act_l, logp_l, vf_l, rew_l, done_l = [], [], [], [], [], []
        bonus_l = []
        obs = self.vec.obs
        for _ in range(rollout_len):
            t_obs = self._obs_in(obs, self._last_dones)
            actions, logp, value = self.module.forward_exploration(
                self._on_device(t_obs), self.gen)
            # One copy back: actions (small ints, exact in f32), logp, value.
            out = torch.stack([actions.float(), logp, value]).cpu().numpy()
            actions = out[0].astype(np.int32)
            obs_l.append(t_obs)
            act_l.append(actions)
            logp_l.append(out[1])
            vf_l.append(out[2])
            obs, rewards, dones, truncs, final_obs = self.vec.step(actions)
            self._last_dones = dones
            bonus = np.zeros(len(rewards), np.float32)
            if truncs.any():
                # Truncation bootstrap: gamma * V(s_T) at time-limit cuts
                # so the value target doesn't bias toward zero.  Shipped
                # SEPARATELY from the raw rewards — learner connectors
                # (e.g. reward clipping) must see the env's rewards, not
                # the bootstrap, which the learner adds back after them.
                # Peek on the FULL [N] batch (stateful connectors keep
                # [N]-row history), then select the truncated rows.
                full = obs.astype(np.float32).copy()
                for i in np.where(truncs)[0]:
                    full[i] = final_obs[i]
                fin = self._obs_peek(full)[truncs]
                bonus[truncs] = self.gamma * self._value(fin)
            rew_l.append(rewards)
            bonus_l.append(bonus)
            done_l.append(dones)
        final_t = self._obs_peek(obs)
        return {
            # [T, N, ...] time-major stacks
            "obs": np.stack(obs_l),
            "actions": np.stack(act_l),
            "logp": np.stack(logp_l),
            "vf": np.stack(vf_l),
            "rewards": np.stack(rew_l),
            "trunc_bonus": np.stack(bonus_l),
            "dones": np.stack(done_l),
            "bootstrap_value": self._value(final_t),
            # Final observations (connector space): off-policy learners
            # (V-trace) recompute the bootstrap value with CURRENT params
            # instead of trusting the stale runner-side vf.
            "final_obs": final_t,
            "episode_returns": self.vec.drain_returns(),
        }

    @torch.no_grad()
    def sample_transitions(self, weights, n_steps: int,
                           epsilon: float) -> Dict[str, Any]:
        """Epsilon-greedy flat transition collection for off-policy
        algorithms (reference: env runners feeding
        utils/replay_buffers — obs/action/reward/next_obs/done rows).

        Terminals are REAL terminals only: a time-limit truncation stores
        done=False with the true final observation as next_obs, so the
        Q target still bootstraps through the cut (reference: episode
        truncation handling in single_agent_env_runner).  Arrays come
        back time-major [T, N, ...] with a `resets` mask (done OR trunc)
        so the caller can fold n-step returns without blending
        episodes."""
        self.module.set_weights(weights)
        rows_obs, rows_next, rows_act, rows_rew = [], [], [], []
        rows_done, rows_reset = [], []
        obs = self.vec.obs
        n_envs = obs.shape[0]
        rng = self._np_rng
        for _ in range(n_steps):
            t_obs = self._obs_in(obs, self._last_dones)
            if epsilon < 0:
                # Stochastic-policy exploration (SAC): sample from pi
                # itself; entropy regularization replaces epsilon noise.
                actions = self.module.forward_sample(
                    self._on_device(t_obs), self.gen).cpu().numpy()
            else:
                greedy = self.module.forward_inference(
                    self._on_device(t_obs)).cpu().numpy()
                explore = rng.random(n_envs) < epsilon
                actions = np.where(
                    explore, rng.integers(0, self.module.spec.num_actions,
                                          n_envs), greedy)
            obs, rewards, dones, truncs, final_obs = self.vec.step(actions)
            self._last_dones = dones
            next_obs = obs.astype(np.float32)  # astype = private copy
            for i in np.where(truncs)[0]:
                next_obs[i] = final_obs[i]
            # Same-episode lookahead transform: state advances only at the
            # next iteration's _obs_in (done rows there reset the stack).
            rows_obs.append(t_obs)
            rows_next.append(self._obs_peek(next_obs))
            rows_act.append(actions)
            rows_rew.append(rewards)
            rows_done.append(dones & ~truncs)
            rows_reset.append(dones)
        return {
            "obs": np.stack(rows_obs),
            "next_obs": np.stack(rows_next),
            "actions": np.stack(rows_act).astype(np.int32),
            "rewards": np.stack(rows_rew).astype(np.float32),
            "dones": np.stack(rows_done),
            "resets": np.stack(rows_reset),
            "episode_returns": self.vec.drain_returns(),
        }


class EnvRunnerGroup:
    """Fan-out over EnvRunner actors of ``runtime`` (reference:
    env/env_runner_group.py)."""

    def __init__(self, *, env_name: str, spec_kwargs: Dict[str, Any],
                 num_env_runners: int, num_envs_per_runner: int, seed: int,
                 runner_resources: Optional[dict] = None,
                 gamma: float = 0.99, env_to_module=None,
                 device: Union[str, torch.device] = "cuda", runtime=None):
        self._rt = runtime or LocalRuntime()
        res = dict(runner_resources or {})
        # Each runner gets its OWN connector instance (the runtime copies
        # constructor arguments): per-runner state like NormalizeObs
        # statistics is independent, matching the reference's
        # per-EnvRunner connector copies.
        self.runners = [
            self._rt.remote(EnvRunner, num_cpus=res.get("num_cpus", 1),
                            resources=res.get("resources"))(
                env_name, spec_kwargs, num_envs_per_runner,
                seed + 10_000 * i, gamma, env_to_module, device)
            for i in range(num_env_runners)]

    def sample(self, weights_ref, rollout_len: int) -> List[Dict[str, Any]]:
        refs = [r.sample.remote(weights_ref, rollout_len)
                for r in self.runners]
        return self._rt.get(refs, timeout=300)

    def stop(self):
        for r in self.runners:
            self._rt.kill(r)
