"""Replay buffers: uniform transition, episode, and prioritized. A copy
of ray_tpu/rllib/replay_buffers.py.

Reference surface: python/ray/rllib/utils/replay_buffers/ —
ReplayBuffer (replay_buffer.py), EpisodeReplayBuffer
(episode_replay_buffer.py), PrioritizedEpisodeReplayBuffer
(prioritized_episode_replay_buffer.py, proportional prioritization per
Schaul et al.). Buffers are columnar numpy rings on the learner's
host, sampled with a seeded numpy generator, so a buffer here draws the
same batches as the reference's; prioritization uses a segment tree for
O(log N) updates exactly like the reference's sum-tree.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class ReplayBuffer:
    """Uniform FIFO transition buffer over columnar storage.

    add() takes a batch dict of arrays with a shared leading dimension;
    sample(n) returns a dict of stacked columns drawn uniformly with
    replacement (reference: replay_buffer.py add/sample).
    """

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._next = 0          # ring write cursor
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
        if n > self.capacity:
            batch = {k: np.asarray(v)[-self.capacity:]
                     for k, v in batch.items()}
            n = self.capacity
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        self._on_add(idx)

    def _on_add(self, idx: np.ndarray) -> None:
        pass

    def sample(self, num_items: int) -> Dict[str, np.ndarray]:
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        idx = self._rng.integers(0, self._size, num_items)
        out = {k: v[idx] for k, v in self._cols.items()}
        out["batch_indexes"] = idx
        return out


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    prioritized_episode_replay_buffer.py; Schaul et al. 2016).

    Sampling probability ~ p_i^alpha via a flat segment (sum) tree;
    sample() also returns importance weights (beta-annealed, normalized
    by the max weight) and the indices to pass back to
    update_priorities().
    """

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = float(alpha)
        # Perfect binary segment tree over `capacity` leaves.
        self._tree_size = 1
        while self._tree_size < self.capacity:
            self._tree_size *= 2
        self._sum_tree = np.zeros(2 * self._tree_size, np.float64)
        self._max_prio = 1.0

    # -------------------------------------------------------- segment tree
    def _tree_set(self, idx: np.ndarray, prio: np.ndarray) -> None:
        pos = idx + self._tree_size
        self._sum_tree[pos] = prio
        pos //= 2
        while pos[0] >= 1:
            left = self._sum_tree[2 * pos]
            right = self._sum_tree[2 * pos + 1]
            self._sum_tree[pos] = left + right
            pos //= 2

    def _tree_sample(self, n: int) -> np.ndarray:
        """Draw n leaves with probability proportional to leaf mass."""
        total = self._sum_tree[1]
        targets = self._rng.random(n) * total
        pos = np.ones(n, np.int64)
        while pos[0] < self._tree_size:
            left = self._sum_tree[2 * pos]
            go_right = targets >= left
            targets = np.where(go_right, targets - left, targets)
            pos = 2 * pos + go_right
        return pos - self._tree_size

    # ---------------------------------------------------------------- api
    def _on_add(self, idx: np.ndarray) -> None:
        # New transitions enter at max priority so they are replayed at
        # least once before TD error demotes them.
        self._tree_set(idx, np.full(len(idx),
                                    self._max_prio ** self.alpha))

    def sample(self, num_items: int,
               beta: float = 0.4) -> Dict[str, np.ndarray]:
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        idx = self._tree_sample(num_items)
        idx = np.minimum(idx, self._size - 1)
        probs = self._sum_tree[idx + self._tree_size] / self._sum_tree[1]
        weights = (self._size * probs) ** (-beta)
        weights /= weights.max()
        out = {k: v[idx] for k, v in self._cols.items()}
        out["batch_indexes"] = idx
        out["weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
        self._max_prio = max(self._max_prio, float(priorities.max()))
        self._tree_set(np.asarray(idx, np.int64),
                       priorities ** self.alpha)


class EpisodeReplayBuffer:
    """Episode-granular buffer (reference: episode_replay_buffer.py —
    stores whole episodes, evicts oldest once the timestep budget is
    exceeded, samples uniformly over timesteps)."""

    def __init__(self, capacity: int = 10_000, seed: int = 0):
        self.capacity = int(capacity)      # in timesteps
        self._episodes: List[Dict[str, np.ndarray]] = []
        self._timesteps = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._timesteps

    @property
    def num_episodes(self) -> int:
        return len(self._episodes)

    def add(self, episode: Dict[str, np.ndarray]) -> None:
        """episode: dict of [T, ...] arrays (same T across keys)."""
        t = len(next(iter(episode.values())))
        self._episodes.append({k: np.asarray(v) for k, v in
                               episode.items()})
        self._timesteps += t
        while self._timesteps > self.capacity and len(self._episodes) > 1:
            gone = self._episodes.pop(0)
            self._timesteps -= len(next(iter(gone.values())))

    def sample(self, num_items: int) -> Dict[str, np.ndarray]:
        """Uniform over stored timesteps: pick episodes ~ length, then a
        timestep inside each."""
        if not self._episodes:
            raise ValueError("cannot sample from an empty buffer")
        lens = np.array([len(next(iter(e.values())))
                         for e in self._episodes])
        eps = self._rng.choice(len(self._episodes), num_items,
                               p=lens / lens.sum())
        cols: Dict[str, list] = {k: [] for k in self._episodes[0]}
        for e in eps:
            t = self._rng.integers(0, lens[e])
            for k, col in cols.items():
                col.append(self._episodes[e][k][t])
        return {k: np.stack(v) for k, v in cols.items()}
