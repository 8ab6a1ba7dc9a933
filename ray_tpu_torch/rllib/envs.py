"""The environments the port's rllib runs, without gymnasium.

The reference makes its environments with ``gymnasium.make`` (in
ray_tpu/rllib/env_runner.py and algorithm.py). The port keeps its own copy
of the one environment the reference's rllib and its tests use,
``"CartPole-v1"``: gymnasium 1.2.2's ``CartPoleEnv`` under the
``TimeLimit`` of its registration (500 steps). The dynamics, the seeding
and the types are gymnasium's, so an episode here is the same one, bit
for bit: the state is float64 and stepped with numpy scalars, the
observations are float32, the reward is a Python float.

``make`` knows only the names in ``REGISTRY``; any other name raises.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class Discrete:
    """The action space of ``n`` choices (gymnasium.spaces.Discrete)."""

    def __init__(self, n: int):
        self.n = int(n)

    def contains(self, x) -> bool:
        return isinstance(x, (int, np.integer)) and 0 <= int(x) < self.n


class Box:
    """A float observation space between ``low`` and ``high``
    (gymnasium.spaces.Box; only its bounds and shape)."""

    def __init__(self, low: np.ndarray, high: np.ndarray, dtype=np.float32):
        self.low = np.asarray(low, dtype)
        self.high = np.asarray(high, dtype)
        self.shape = self.low.shape
        self.dtype = np.dtype(dtype)


def np_random(seed: Optional[int] = None) -> np.random.Generator:
    """gymnasium.utils.seeding.np_random: PCG64 over a SeedSequence."""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"seed must be a non-negative int or None, "
                         f"got {seed!r}")
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


class CartPoleEnv:
    """gymnasium's CartPoleEnv (classic_control/cartpole.py): the pole on
    a cart, pushed left (0) or right (1) by 10 N, Euler-integrated at
    0.02 s; the episode terminates when the cart leaves +-2.4 or the pole
    leans past 12 degrees; reward 1 a step, the terminating one
    included."""

    def __init__(self):
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02  # seconds between state updates
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.np_random: Optional[np.random.Generator] = None
        self.state: Optional[np.ndarray] = None
        self.steps_beyond_terminated: Optional[int] = None

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool, dict]:
        if not self.action_space.contains(action):
            raise ValueError(f"{action!r} ({type(action)}) invalid")
        if self.state is None:
            raise RuntimeError("call reset before step")
        # Unpacking the float64 array gives numpy scalars, and np.cos /
        # np.sin / np.square on them round as gymnasium's do.
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / self.total_mass))
        xacc = (temp - self.polemass_length * thetaacc * costheta
                / self.total_mass)
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(
            x < -self.x_threshold or x > self.x_threshold
            or theta < -self.theta_threshold_radians
            or theta > self.theta_threshold_radians)
        if not terminated:
            reward = 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0   # the pole just fell
            reward = 1.0
        else:
            self.steps_beyond_terminated += 1  # stepped past the end
            reward = 0.0
        return (np.array(self.state, dtype=np.float32), reward, terminated,
                False, {})

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[np.ndarray, dict]:
        """A seed starts a new generator; without one the current
        generator continues (an unseeded one on the first reset)."""
        if seed is not None or self.np_random is None:
            self.np_random = np_random(seed)
        self.state = self.np_random.uniform(low=-0.05, high=0.05, size=(4,))
        self.steps_beyond_terminated = None
        return np.array(self.state, dtype=np.float32), {}

    def close(self) -> None:
        pass


class TimeLimit:
    """gymnasium.wrappers.TimeLimit: the episode is truncated once it has
    taken ``max_episode_steps`` steps."""

    def __init__(self, env, max_episode_steps: int):
        self.env = env
        self.max_episode_steps = int(max_episode_steps)
        self._elapsed_steps: Optional[int] = None
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    @property
    def unwrapped(self):
        return self.env

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self.max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info

    def reset(self, **kwargs):
        self._elapsed_steps = 0
        return self.env.reset(**kwargs)

    def close(self) -> None:
        self.env.close()


# name -> (constructor, max_episode_steps), as gymnasium registers them.
REGISTRY: Dict[str, Tuple[Callable[[], Any], int]] = {
    "CartPole-v1": (CartPoleEnv, 500),
}


def make(name: str):
    """The environment registered as ``name``, under its time limit."""
    if name not in REGISTRY:
        raise ValueError(
            f"unknown environment {name!r}: the port ships its own copies "
            f"of {sorted(REGISTRY)} and does not use gymnasium")
    ctor, max_steps = REGISTRY[name]
    return TimeLimit(ctor(), max_steps)
