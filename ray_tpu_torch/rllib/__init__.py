"""ray_tpu_torch.rllib: the single-agent online half of ray_tpu.rllib.

Port of ray_tpu/rllib (reference surface: python/ray/rllib —
AlgorithmConfig/Algorithm (algorithms/algorithm.py:212), EnvRunnerGroup
(env/env_runner_group.py), RLModule (core/rl_module/rl_module.py),
Learner/LearnerGroup (core/learner/learner.py:112, learner_group.py:101),
PPO, IMPALA, APPO, DQN and SAC). Learners and the runners' policy run on
``AlgorithmConfig.device`` ("cuda" by default); environments are the
port's own copies (``envs``); runtime services come from a runtime object
(``LocalRuntime`` by default, ``_runtime.py``). The offline algorithms
(BC, MARWIL, CQL, IQL) and multi-agent training are not ported yet.
"""

from ._runtime import LocalRuntime
from .algorithm import Algorithm, AlgorithmConfig
from .appo import APPO, APPOConfig, AppoLearner
from .connectors import (ClipRewards, Connector, ConnectorPipeline,
                         FlattenObs, FrameStack, NormalizeObs)
from .dqn import DQN, DQNConfig, DQNLearner
from .env_runner import EnvRunner, EnvRunnerGroup
from .impala import (IMPALA, AggregatorActor, IMPALAConfig, ImpalaLearner,
                     vtrace)
from .learner import Learner, LearnerGroup, compute_gae
from .ppo import PPO, PPOConfig
from .replay_buffers import (EpisodeReplayBuffer, PrioritizedReplayBuffer,
                             ReplayBuffer)
from .rl_module import RLModule, RLModuleSpec
from .sac import SAC, SACConfig, SACLearner

__all__ = [
    "Algorithm", "AlgorithmConfig", "AggregatorActor", "APPO",
    "APPOConfig", "AppoLearner", "ClipRewards", "Connector",
    "ConnectorPipeline", "DQN", "DQNConfig", "DQNLearner", "EnvRunner",
    "EnvRunnerGroup", "EpisodeReplayBuffer", "FlattenObs", "FrameStack",
    "IMPALA", "IMPALAConfig", "ImpalaLearner", "Learner", "LearnerGroup",
    "LocalRuntime", "NormalizeObs", "PrioritizedReplayBuffer",
    "ReplayBuffer", "SAC", "SACConfig", "SACLearner", "compute_gae",
    "PPO", "PPOConfig", "RLModule", "RLModuleSpec", "vtrace",
]
