"""AlgorithmConfig + Algorithm: the RLlib training loop.

Port of ray_tpu/rllib/algorithm.py (reference surface:
python/ray/rllib/algorithms/algorithm_config.py, the fluent config, and
algorithms/algorithm.py:212, Algorithm: train()/save()/restore()/stop()).
Every call the reference's Algorithm makes to its runtime (``remote``,
``put``, ``get``, ``wait``, ``kill``) is a call on ``self._rt``, a
``LocalRuntime`` unless the caller gives another runtime (see
``_runtime.py``). The learner and every runner run on ``config.device``.
With ``multi_agent()`` each policy has its own LearnerGroup and the
runners are ``multi_agent.MultiAgentEnvRunner``s.
"""

from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Type

import numpy as np
import torch

from .._device import resolve_device
from . import envs
from ._runtime import LocalRuntime
from .env_runner import EnvRunnerGroup
from .learner import LearnerGroup
from .multi_agent import MultiAgentEnvRunnerGroup


class AlgorithmConfig:
    """Fluent config (reference: algorithm_config.py). Sections mirror the
    reference's: environment() / env_runners() / training() / learners() /
    resources() / debugging(); build_algo() constructs the Algorithm."""

    algo_class: Optional[Type["Algorithm"]] = None

    def __init__(self):
        self.env: Optional[str] = None
        self.num_env_runners = 2
        self.num_envs_per_env_runner = 8
        self.rollout_fragment_length = 64
        self.num_learners = 0
        self.learner_resources: Dict[str, Any] = {}
        self.runner_resources: Dict[str, Any] = {}
        self.lr = 3e-4
        self.gamma = 0.99
        self.train_config: Dict[str, Any] = {}
        self.hiddens = (64, 64)
        self.seed = 0
        # Where the learner and the runners' modules live.
        self.device = "cuda"
        # Connector pipelines (reference: ConnectorV2): env_to_module
        # runs in every EnvRunner before inference; learner_connectors
        # run in the Learner on each sample batch before the update.
        self.env_to_module = None
        self.learner_connectors: Optional[list] = None
        # Multi-agent (reference: algorithm_config.py multi_agent()):
        # policies + agent->policy mapping; env must then be a
        # MultiAgentEnv factory callable.
        self.policies: Optional[Dict[str, dict]] = None
        self.policy_mapping_fn: Optional[Any] = None

    # ------------------------------------------------------------ sections --
    def environment(self, env: str) -> "AlgorithmConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    env_to_module=None) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if env_to_module is not None:
            self.env_to_module = env_to_module
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 model: Optional[dict] = None,
                 **kwargs) -> "AlgorithmConfig":
        if lr is not None:
            self.lr = lr
        if gamma is not None:
            self.gamma = gamma
        if model:
            self.hiddens = tuple(model.get("fcnet_hiddens", self.hiddens))
        self.train_config.update(kwargs)
        return self

    def learners(self, *, num_learners: Optional[int] = None,
                 learner_resources: Optional[dict] = None
                 ) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if learner_resources is not None:
            self.learner_resources = dict(learner_resources)
        return self

    def resources(self, *, device: Optional[str] = None
                  ) -> "AlgorithmConfig":
        """``device``: "cuda" (the default) or "cpu", for the learner and
        every runner."""
        if device is not None:
            self.device = device
        return self

    def multi_agent(self, *, policies, policy_mapping_fn
                    ) -> "AlgorithmConfig":
        """Configure per-policy training (reference:
        algorithm_config.py multi_agent(policies, policy_mapping_fn)).
        `policies`: list of policy ids, or {policy_id: {} } dict;
        `policy_mapping_fn(agent_id) -> policy_id`."""
        if isinstance(policies, (list, tuple, set)):
            self.policies = {p: {} for p in policies}
        else:
            self.policies = dict(policies)
        if "episode_returns" in self.policies:
            # Reserved: sample batches carry the drained returns under
            # this key alongside the per-policy batches.
            raise ValueError(
                "'episode_returns' is a reserved name and cannot be a "
                "policy id")
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build_algo(self, runtime=None) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("use a concrete config (e.g. PPOConfig)")
        return self.algo_class(self.copy(), runtime=runtime)

    # Back-compat alias matching the reference's AlgorithmConfig.build().
    build = build_algo

    def learner_config_dict(self) -> Dict[str, Any]:
        cfg = {"lr": self.lr, "gamma": self.gamma}
        cfg.update(self.train_config)
        if self.learner_connectors:
            cfg.setdefault("learner_connectors", self.learner_connectors)
        return cfg


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


class Algorithm:
    """The training loop (reference: algorithm.py; Trainable
    surface: train()/save()/restore()/stop())."""

    # Subclasses select their loss family here (reference: Algorithm
    # subclasses override get_default_learner_class).
    learner_class: Optional[type] = None

    def __init__(self, config: AlgorithmConfig, runtime=None):
        self.config = config
        self._rt = runtime or LocalRuntime()
        self.device = resolve_device(config.device)
        self.iteration = 0
        self._episode_returns: List[float] = []
        if config.policies:
            self._init_multi_agent(config)
            return
        spec_kwargs = self._module_spec_kwargs(config)
        self.learner_group = LearnerGroup(
            spec_kwargs, config.learner_config_dict(),
            num_learners=config.num_learners,
            learner_resources=config.learner_resources, seed=config.seed,
            learner_cls=self.learner_class, device=self.device,
            runtime=self._rt)
        self.env_runner_group = EnvRunnerGroup(
            env_name=config.env, spec_kwargs=spec_kwargs,
            num_env_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_env_runner,
            seed=config.seed, runner_resources=config.runner_resources,
            gamma=config.gamma, env_to_module=config.env_to_module,
            device=self.device, runtime=self._rt)

    # -------------------------------------------------------- multi-agent ---
    def _init_multi_agent(self, config: AlgorithmConfig):
        """Per-policy learner groups + multi-agent runner group
        (reference: MultiRLModule / LearnerGroup keyed per module_id)."""
        if type(self).training_step is not Algorithm.training_step:
            # Off-policy/replay algorithms override training_step and
            # drive self.learner_group directly — failing HERE beats an
            # AttributeError three layers into their loop (reference:
            # multi-agent support is per-algorithm there too).
            raise NotImplementedError(
                f"{type(self).__name__} does not support multi_agent() "
                "on this runtime; use PPO (on-policy, per-policy "
                "learner groups)")
        if config.env_to_module is not None:
            # Silently feeding raw observations while the config names a
            # connector would train a different model than configured.
            raise NotImplementedError(
                "env_to_module connectors are not supported with "
                "multi_agent() on this runtime; transform observations "
                "inside the MultiAgentEnv")
        if not callable(config.env):
            raise ValueError(
                "multi-agent training needs environment(env=<callable "
                "returning a MultiAgentEnv>) — string envs are gym "
                "single-agent")
        probe = config.env()
        try:
            agent_to_policy = {a: config.policy_mapping_fn(a)
                               for a in probe.agents}
            unknown = set(agent_to_policy.values()) - set(config.policies)
            if unknown:
                raise ValueError(
                    f"policy_mapping_fn produced unknown policies "
                    f"{unknown}")
            unmapped = set(config.policies) - set(agent_to_policy.values())
            if unmapped:
                # A declared-but-never-mapped policy would silently never
                # train (and its checkpoint state would be missing).
                raise ValueError(
                    f"policies {sorted(unmapped)} are declared but "
                    "policy_mapping_fn maps no agent to them")
            policy_specs: Dict[str, dict] = {}
            for agent, policy in agent_to_policy.items():
                obs_dim = int(np.prod(
                    probe.observation_spaces[agent].shape))
                num_actions = int(probe.action_spaces[agent].n)
                spec = {"obs_dim": obs_dim, "num_actions": num_actions,
                        "hiddens": config.hiddens}
                prev = policy_specs.setdefault(policy, spec)
                if prev != spec:
                    raise ValueError(
                        f"agents of policy {policy!r} disagree on "
                        "observation/action spaces")
        finally:
            if hasattr(probe, "close"):
                probe.close()
        self.learner_groups = {
            p: LearnerGroup(
                policy_specs[p], config.learner_config_dict(),
                num_learners=config.num_learners,
                learner_resources=config.learner_resources,
                seed=config.seed + i, learner_cls=self.learner_class,
                device=self.device, runtime=self._rt)
            for i, p in enumerate(sorted(policy_specs))}
        self.env_runner_group = MultiAgentEnvRunnerGroup(
            env_maker=config.env, policy_specs=policy_specs,
            agent_to_policy=agent_to_policy,
            num_env_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_env_runner,
            seed=config.seed, gamma=config.gamma,
            runner_resources=config.runner_resources, device=self.device,
            runtime=self._rt)
        self.learner_group = None   # single-agent surface unused

    def _training_step_multi_agent(self) -> Dict[str, Any]:
        weights_ref = self._rt.put(
            {p: lg.get_weights() for p, lg in self.learner_groups.items()})
        t0 = time.monotonic()
        samples = self.env_runner_group.sample(
            weights_ref, self.config.rollout_fragment_length)
        sample_s = time.monotonic() - t0
        metrics: Dict[str, Any] = {"sample_time_s": sample_s}
        for s in samples:
            self._episode_returns.extend(s.pop("episode_returns"))
        t1 = time.monotonic()
        # Dispatch every policy's update first, gather after: remote
        # learner actors then run concurrently (sequential update() would
        # make learn time the SUM over policies instead of the max).
        pending = {p: (lg, lg.update_async([s[p] for s in samples]))
                   for p, lg in self.learner_groups.items()}
        for p, (lg, res) in pending.items():
            pm = self._rt.get(res, timeout=600) if lg.is_remote else res
            metrics.update({f"{p}/{k}": v for k, v in pm.items()})
        metrics["learn_time_s"] = time.monotonic() - t1
        return metrics

    @staticmethod
    def _module_spec_kwargs(config: AlgorithmConfig) -> Dict[str, Any]:
        probe = envs.make(config.env)
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        probe.close()
        if config.env_to_module is not None:
            # The module sees connector-space observations.
            obs_dim = config.env_to_module.transform_obs_dim(obs_dim)
        return {"obs_dim": obs_dim, "num_actions": num_actions,
                "hiddens": config.hiddens}

    # -------------------------------------------------------------- train ---
    def training_step(self) -> Dict[str, Any]:
        """sample -> learner update -> (weights broadcast next iteration)
        (reference: algorithm.py training_step / ppo.py)."""
        if self.config.policies:
            return self._training_step_multi_agent()
        weights_ref = self._rt.put(self.learner_group.get_weights())
        t0 = time.monotonic()
        samples = self.env_runner_group.sample(
            weights_ref, self.config.rollout_fragment_length)
        sample_s = time.monotonic() - t0
        for s in samples:
            self._episode_returns.extend(s.pop("episode_returns"))
        t1 = time.monotonic()
        metrics = self.learner_group.update(samples)
        metrics["sample_time_s"] = sample_s
        metrics["learn_time_s"] = time.monotonic() - t1
        return metrics

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        metrics = self.training_step()
        recent = self._episode_returns[-100:]
        metrics.update({
            "training_iteration": self.iteration,
            "episode_return_mean": float(np.mean(recent)) if recent
            else float("nan"),
            "num_episodes": len(self._episode_returns),
        })
        return metrics

    # -------------------------------------------------- checkpoint surface --
    def save(self, path: str) -> str:
        """Pickle the learner state (host copies; one per policy under
        multi_agent()), the iteration and the last 100 episode returns."""
        os.makedirs(path, exist_ok=True)
        if self.config.policies:
            learner_state = {p: _to_cpu(lg.get_state())
                             for p, lg in self.learner_groups.items()}
        else:
            learner_state = _to_cpu(self.learner_group.get_state())
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            pickle.dump({"iteration": self.iteration,
                         "learner": learner_state,
                         "episode_returns": self._episode_returns[-100:]}, f)
        return path

    def restore(self, path: str):
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.iteration = state["iteration"]
        self._episode_returns = list(state["episode_returns"])
        if self.config.policies:
            for p, lg in self.learner_groups.items():
                lg.set_state(state["learner"][p])
        else:
            self.learner_group.set_state(state["learner"])

    def stop(self):
        self.env_runner_group.stop()
        if self.config.policies:
            for lg in self.learner_groups.values():
                lg.stop()
        else:
            self.learner_group.stop()
