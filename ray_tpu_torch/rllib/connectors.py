"""Connector pipelines: composable data transformations between env,
module, and learner. A copy of ray_tpu/rllib/connectors.py.

Reference surface: python/ray/rllib/connectors/connector_v2.py — a
ConnectorV2 is a callable transformation stage; pipelines compose them
env-to-module (observation preprocessing before inference),
module-to-env (action postprocessing), and learner (batch preprocessing
before the update). Connectors run on the HOST as plain numpy: they shape
the data that enters the learner's step and the runner's forward pass,
and are never part of either.

Stateful stages (FrameStack, NormalizeObs) keep per-env host state and
reset it on episode boundaries via the `dones` entry in the call
context."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One transformation stage.  __call__(data, ctx) -> data where
    `data` is a dict of numpy arrays ({"obs": [N, ...]} on the
    env-to-module side, a flat batch on the learner side) and `ctx`
    carries side info ({"dones": [N] bool} after env steps)."""

    def __call__(self, data: Dict[str, Any],
                 ctx: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def transform_obs_dim(self, obs_dim: int) -> int:
        """How this stage changes the flattened observation width (the
        module spec is built from the POST-pipeline width)."""
        return obs_dim

    def peek(self, data: Dict[str, Any],
             ctx: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Transform WITHOUT advancing internal state — used for
        same-episode lookahead reads (next_obs for Q targets, bootstrap
        values) where the real state advance happens on the next step's
        __call__.  Stateless stages just call themselves."""
        return self(data, ctx)

    def reset(self) -> None:
        """Drop per-env state (new rollout worker / env set)."""


class ConnectorPipeline(Connector):
    """Ordered composition (reference: ConnectorPipelineV2): stages run
    left to right; prepend/append/insert mirror the reference's pipeline
    editing surface."""

    def __init__(self, *stages: Connector):
        self.stages: List[Connector] = list(stages)

    def __call__(self, data, ctx=None):
        for s in self.stages:
            data = s(data, ctx)
        return data

    def transform_obs_dim(self, obs_dim: int) -> int:
        for s in self.stages:
            obs_dim = s.transform_obs_dim(obs_dim)
        return obs_dim

    def peek(self, data, ctx=None):
        for s in self.stages:
            data = s.peek(data, ctx)
        return data

    def reset(self) -> None:
        for s in self.stages:
            s.reset()

    def append(self, stage: Connector) -> "ConnectorPipeline":
        self.stages.append(stage)
        return self

    def prepend(self, stage: Connector) -> "ConnectorPipeline":
        self.stages.insert(0, stage)
        return self

    def insert_after(self, cls: type, stage: Connector) -> None:
        for i, s in enumerate(self.stages):
            if isinstance(s, cls):
                self.stages.insert(i + 1, stage)
                return
        raise ValueError(f"no stage of type {cls.__name__} in pipeline")


class FlattenObs(Connector):
    """[N, ...] observations -> [N, prod(...)] (reference: the default
    env-to-module flatten for Box spaces)."""

    def __call__(self, data, ctx=None):
        obs = np.asarray(data["obs"])
        data["obs"] = obs.reshape(obs.shape[0], -1)
        return data


class FrameStack(Connector):
    """Stack the last k observations per env along the feature axis;
    episode boundaries reset a slot's history to zeros (reference:
    connectors/env_to_module/frame_stacking.py)."""

    def __init__(self, k: int):
        self.k = int(k)
        self._hist: Optional[np.ndarray] = None   # [N, k, D]

    def transform_obs_dim(self, obs_dim: int) -> int:
        return obs_dim * self.k

    def reset(self) -> None:
        self._hist = None

    def __call__(self, data, ctx=None):
        obs = np.asarray(data["obs"], np.float32)
        n, d = obs.shape
        if self._hist is None or self._hist.shape[0] != n:
            self._hist = np.zeros((n, self.k, d), np.float32)
        if ctx and ctx.get("dones") is not None:
            self._hist[np.asarray(ctx["dones"], bool)] = 0.0
        self._hist = np.roll(self._hist, -1, axis=1)
        self._hist[:, -1] = obs
        # Copy, not a view: the recorded observation must not be
        # retroactively zeroed by next step's episode-reset mutation.
        data["obs"] = self._hist.reshape(n, self.k * d).copy()
        return data

    def peek(self, data, ctx=None):
        obs = np.asarray(data["obs"], np.float32)
        n, d = obs.shape
        hist = (np.zeros((n, self.k, d), np.float32)
                if self._hist is None or self._hist.shape[0] != n
                else self._hist.copy())
        hist = np.roll(hist, -1, axis=1)
        hist[:, -1] = obs
        out = dict(data)
        out["obs"] = hist.reshape(n, self.k * d)
        return out


class NormalizeObs(Connector):
    """Running mean/std observation filter (reference:
    connectors/env_to_module/mean_std_filter.py).  Welford accumulation
    on the host; frozen (update=False) copies serve evaluation."""

    def __init__(self, update: bool = True, eps: float = 1e-8):
        self.update = update
        self.eps = eps
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def reset(self) -> None:
        pass      # the filter's statistics deliberately survive resets

    def __call__(self, data, ctx=None):
        obs = np.asarray(data["obs"], np.float32)
        if self.mean is None:
            self.mean = np.zeros(obs.shape[-1], np.float32)
            self.m2 = np.zeros(obs.shape[-1], np.float32)
        if self.update:
            for row in obs:
                self.count += 1.0
                delta = row - self.mean
                self.mean += delta / self.count
                self.m2 += delta * (row - self.mean)
        if self.count > 1:
            std = np.sqrt(self.m2 / (self.count - 1)) + self.eps
            data["obs"] = (obs - self.mean) / std
        return data

    def peek(self, data, ctx=None):
        out = dict(data)
        obs = np.asarray(out["obs"], np.float32)
        if self.mean is not None and self.count > 1:
            std = np.sqrt(self.m2 / (self.count - 1)) + self.eps
            out["obs"] = (obs - self.mean) / std
        return out

    def get_state(self) -> Dict[str, Any]:
        return {"count": self.count, "mean": self.mean, "m2": self.m2}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


class ClipRewards(Connector):
    """Learner-side reward clipping (reference:
    connectors/learner/... reward clipping in the default learner
    pipeline)."""

    def __init__(self, limit: float = 1.0):
        self.limit = float(limit)

    def __call__(self, data, ctx=None):
        if "rewards" in data:
            data["rewards"] = np.clip(np.asarray(data["rewards"]),
                                      -self.limit, self.limit)
        return data
